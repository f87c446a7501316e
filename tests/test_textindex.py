"""Streaming text intake (textindex.py): byte-identical to the in-RAM
loader across multi-chromosome, multi-window scenes, with an O(window)
working set."""
import os

import numpy as np
import pytest

from pindel_tpu.config import Settings
from pindel_tpu.pipeline import run_files


def _scene(tmp_path, chroms=("chrA", "chrB"), chrom_len=120_000,
           window_size=30_000):
    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))), "tools"))
    from make_fai import make_fai

    from pindel_tpu.testing.simulate import standard_scene, write_fasta
    refs, all_reads = [], []
    txt = os.path.join(str(tmp_path), "reads.txt")
    with open(txt, "w") as out:
        for ci, chrom in enumerate(chroms):
            ref, _, reads = standard_scene(
                seed=100 + ci, chrom_len=chrom_len,
                kinds=["DEL", "SI", "DI", "TD"] * 3,
                reads_per_event=12, n_noise=60, chrom=chrom)
            refs.append((chrom, ref))
            p = os.path.join(str(tmp_path), f"{chrom}.txt")
            reads.write(p)
            out.write(open(p).read())
    fa = os.path.join(str(tmp_path), "ref.fa")
    write_fasta(fa, refs)
    make_fai(fa)
    return fa, txt


def _run(fa, txt, prefix, stream: bool, window_size=30_000):
    s = Settings()
    s.window_size_mb = window_size / 1e6
    s.analyze_li = True
    s.report_close_mapped_reads = True
    s.stream_text_input = stream
    run_files(fa, txt, prefix, settings=s, backend="numpy")


def test_streaming_matches_inram(tmp_path):
    fa, txt = _scene(tmp_path)
    _run(fa, txt, os.path.join(str(tmp_path), "ram"), stream=False)
    _run(fa, txt, os.path.join(str(tmp_path), "str"), stream=True)
    for suf in ("D", "SI", "TD", "INV", "LI", "CloseEndMapped"):
        a = open(os.path.join(str(tmp_path), f"ram_{suf}")).read()
        b = open(os.path.join(str(tmp_path), f"str_{suf}")).read()
        assert a == b, f"_{suf} diverges under streaming intake"
    assert "ChrID" in open(os.path.join(str(tmp_path), "ram_D")).read()


def test_streaming_index_is_o_window(tmp_path):
    """The index holds positions/offsets only; per-window parses touch
    just that window's records."""
    from pindel_tpu.textindex import PindelTextIndex
    fa, txt = _scene(tmp_path, chroms=("chrA",))
    idx = PindelTextIndex([txt])
    n = idx.n_records
    assert n > 150
    # whole-file reads equal the concatenation of window reads
    from pindel_tpu.reads import read_pindel_file
    whole = list(read_pindel_file(txt))
    got = []
    for lo in range(0, 130_000, 10_000):
        got.extend(idx.window_reads("chrA", lo, lo + 10_000))
    assert len(got) == len(whole)
    whole_sorted = sorted(whole, key=lambda r: (r.matched_rel_pos,))
    got_sorted = sorted(got, key=lambda r: (r.matched_rel_pos,))
    for a, b in zip(got_sorted, whole_sorted):
        assert (a.name, a.seq, a.matched_d, a.matched_rel_pos, a.ms,
                a.insert_size, a.tag) == \
               (b.name, b.seq, b.matched_d, b.matched_rel_pos, b.ms,
                b.insert_size, b.tag)
    idx.close()


def test_streaming_multi_file_config_order(tmp_path):
    """-P config: per window, file-A reads precede file-B reads in file
    order, matching the in-RAM concatenation order."""
    from pindel_tpu.textindex import PindelTextIndex
    a = os.path.join(str(tmp_path), "a.txt")
    b = os.path.join(str(tmp_path), "b.txt")
    seq = "ACGTACGTACGTACGTACGTACGTACGTAC"
    with open(a, "w") as fh:
        for i, pos in enumerate([100, 50, 900]):
            fh.write(f"@a{i}\n{seq}\n+\tchrA\t{pos}\t60\t300\tsA\n")
    with open(b, "w") as fh:
        for i, pos in enumerate([70, 20]):
            fh.write(f"@b{i}\n{seq}\n+\tchrA\t{pos}\t60\t300\tsB\n")
    idx = PindelTextIndex([a, b])
    reads = idx.window_reads("chrA", 0, 500)
    assert [r.name for r in reads] == ["@a0", "@a1", "@b0", "@b1"]
    assert idx.max_pos == 900
    idx.close()


def test_gz_input_streams_via_spill(tmp_path):
    """gz pindel text: decompressed once into a scratch spill, indexed
    there — reports byte-identical to the plain-text run, spill removed
    on close (reference gz_line_reader.cpp instead re-decompresses the
    whole file every window)."""
    import glob
    import gzip
    import tempfile
    fa, txt = _scene(tmp_path)
    gz = txt + ".gz"
    with open(txt, "rb") as src, gzip.open(gz, "wb") as dst:
        dst.write(src.read())
    _run(fa, txt, os.path.join(str(tmp_path), "plain"), stream=True)
    before = set(glob.glob(os.path.join(tempfile.gettempdir(),
                                        "pindel_tpu_gz_*")))
    _run(fa, gz, os.path.join(str(tmp_path), "gz"), stream=True)
    after = set(glob.glob(os.path.join(tempfile.gettempdir(),
                                       "pindel_tpu_gz_*")))
    assert after == before, "gz spill file leaked"
    for suf in ("D", "SI", "TD", "INV", "LI", "CloseEndMapped"):
        a = open(os.path.join(str(tmp_path), f"plain_{suf}")).read()
        b = open(os.path.join(str(tmp_path), f"gz_{suf}")).read()
        assert a == b, f"_{suf} diverges for gz input"
