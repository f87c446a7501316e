"""BAM split-read channel tests.

The reference oracle binary is built against a compile-only htslib stub
(BAM paths abort there), so the BAM channel cannot be golden-tested
against it.  Instead:

* unit tests pin the native reader's record semantics to the reference's
  reader.cpp behavior (filters, orientation, N gates, the duplicate
  self-record quirk of fetch_func_SR);
* an end-to-end test builds a BAM and the pindel-text file containing
  exactly the records the BAM channel emits, and asserts both input paths
  produce identical report files (the text path itself is golden-tested
  against the reference elsewhere).
"""
import os
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

from make_fai import make_fai  # noqa: E402

from pindel_tpu.bam import BamReader, read_bam_config  # noqa: E402
from pindel_tpu.testing.bamwriter import (  # noqa: E402
    FLAG_PAIRED, FLAG_READ1, FLAG_READ2, FLAG_REVERSE, BamRecord,
    anchored_pair, write_bam)


def test_reader_basics(tmp_path):
    ref = "ACGT" * 3000
    recs = anchored_pair("q1", 100, "TTAC" * 25, ref)
    recs += anchored_pair("q2", 500, "GGCA" * 25, ref, anchor_reverse=True)
    bam = str(tmp_path / "t.bam")
    write_bam(bam, [("chrT", len(ref))], recs)
    br = BamReader(bam)
    assert br.ref_names == ["chrT"] and br.n_records == 4
    reads, ref_reads = br.collect_sr("chrT", 0, len(ref), 500, "S1",
                                     len(ref))
    assert [r.name for r in reads] == ["@q1/1", "@q2/1"]
    assert reads[0].matched_d == "+"
    assert reads[0].matched_rel_pos == 100
    # reversed anchor: MatchedRelPos += cigar2len (reader.cpp:863-867)
    assert reads[1].matched_d == "-"
    assert reads[1].matched_rel_pos == 600
    assert not ref_reads  # unmapped mates never qualify as ref reads


def test_reader_self_record_quirk(tmp_path):
    """fetch_func_SR (reader.cpp:1110-1131): a weird read seen before its
    mate is self-built once at first sight and AGAIN when the pair
    completes, plus the anchored record — three records total."""
    ref = "ACGT" * 3000
    recs = anchored_pair("q1", 100, "TTAC" * 25, ref, mate_first=True)
    bam = str(tmp_path / "t.bam")
    write_bam(bam, [("chrT", len(ref))], recs)
    reads, _ = BamReader(bam).collect_sr("chrT", 0, len(ref), 500, "S1",
                                         len(ref))
    assert len(reads) == 3
    assert [r.ms for r in reads] == [0, 0, 60]
    assert [r.matched_d for r in reads] == ["+", "+", "+"]


def test_reader_gates(tmp_path):
    ref = "ACGT" * 3000
    recs = []
    # too short after N-trim (< 22, reader.cpp:849)
    recs += anchored_pair(
        "short", 100, "N" * 40 + "ACGTACGTACGTACGTACGTA" + "N" * 39, ref)
    # too many interior Ns (> 10%)
    seq = ("ACGTACGTACGT" + "N" * 12 + "ACGT" * 19)
    recs += anchored_pair("enn", 300, seq, ref)
    # fine read with leading/trailing N trim
    recs += anchored_pair("ok", 500, "NN" + "TGCA" * 24 + "NN", ref)
    bam = str(tmp_path / "t.bam")
    write_bam(bam, [("chrT", len(ref))], recs)
    reads, _ = BamReader(bam).collect_sr("chrT", 0, len(ref), 500, "S1",
                                         len(ref))
    assert [r.name for r in reads] == ["@ok/1"]
    assert reads[0].read_length == 96


def test_reader_reverse_mate_rc(tmp_path):
    ref = "ACGT" * 3000
    recs = anchored_pair("q", 100, "AACC" * 25, ref)
    recs[1].flag |= FLAG_REVERSE      # unmapped mate marked reverse
    bam = str(tmp_path / "t.bam")
    write_bam(bam, [("chrT", len(ref))], recs)
    reads, _ = BamReader(bam).collect_sr("chrT", 0, len(ref), 500, "S1",
                                         len(ref))
    assert reads[0].seq == "GGTT" * 25   # reverse-complemented on intake


def test_reader_window_query(tmp_path):
    ref = "ACGT" * 3000
    recs = (anchored_pair("a", 100, "TTAC" * 25, ref)
                          + anchored_pair("b", 5000, "GGCA" * 25, ref))
    bam = str(tmp_path / "t.bam")
    write_bam(bam, [("chrT", len(ref))], recs)
    br = BamReader(bam)
    reads, _ = br.collect_sr("chrT", 0, 1000, 500, "S1", len(ref))
    assert [r.name for r in reads] == ["@a/1"]
    reads, _ = br.collect_sr("chrT", 4000, 12000, 500, "S1", len(ref))
    assert [r.name for r in reads] == ["@b/1"]
    # both records overlap [99,101): normal pairing -> one anchored record
    reads, _ = br.collect_sr("chrT", 99, 101, 500, "S1", len(ref))
    assert len(reads) == 1 and reads[0].ms == 60
    # window past both intervals of pair "a": nothing returned
    reads, _ = br.collect_sr("chrT", 200, 4000, 500, "S1", len(ref))
    assert not reads


def _scene_bam_and_text(tmp_path, seed=3):
    """Scene reads as (BAM, equivalent pindel-text, fasta)."""
    import numpy as np

    from pindel_tpu.testing.simulate import standard_scene, write_fasta
    d = str(tmp_path)
    ref, events, sim = standard_scene(
        seed=seed, chrom_len=60_000,
        kinds=["DEL", "SI", "DEL", "DI", "INV", "TD"],
        reads_per_event=8, n_noise=6)
    fa = os.path.join(d, "ref.fa")
    write_fasta(fa, [("chrT", ref)])
    make_fai(fa)

    # order pairs by anchor BAM position (stable)
    entries = []
    for name, seq, meta in zip(sim.names, sim.seqs, sim.metas):
        dstr, ch, pos, mq, ins, tag = meta
        if dstr == "+":
            anchor_pos = pos              # matched_rel_pos == BAM pos
            reverse = False
        else:
            anchor_pos = pos - 100        # matched_rel_pos = pos + 100M
            reverse = True
        if anchor_pos < 0 or anchor_pos + 100 > len(ref):
            continue
        entries.append((anchor_pos, name, seq, dstr, pos, mq, ins, tag,
                        reverse))
    entries.sort(key=lambda e: e[0])

    bam_records = []
    text_lines = []
    for anchor_pos, name, seq, dstr, pos, mq, ins, tag, reverse in entries:
        qname = name[1:-2] if name.startswith("@") else name[:-2]
        bam_records.extend(anchored_pair(qname, anchor_pos, seq, ref,
                                         anchor_reverse=reverse, mapq=mq))
        at_name = name if name.startswith("@") else "@" + name
        text_lines.append(f"{at_name}\n{seq}\n{dstr}\tchrT\t{pos}\t{mq}"
                          f"\t{ins}\t{tag}\n")
    bam = os.path.join(d, "reads.bam")
    write_bam(bam, [("chrT", len(ref))], bam_records)
    txt = os.path.join(d, "reads.txt")
    with open(txt, "w") as fh:
        fh.writelines(text_lines)
    cfg = os.path.join(d, "bam.cfg")
    with open(cfg, "w") as fh:
        fh.write(f"{bam}\t500\tS1\n")
    return d, fa, bam, txt, cfg


@pytest.mark.parametrize("backend", ["numpy", "fused"])
def test_bam_end_to_end_matches_text_path(tmp_path, backend):
    d, fa, bam, txt, cfg = _scene_bam_and_text(tmp_path)
    from pindel_tpu.__main__ import main
    assert main(["-f", fa, "-p", txt, "-o", os.path.join(d, "text"),
                 "--backend", backend]) == 0
    assert main(["-f", fa, "-i", cfg, "-o", os.path.join(d, "bamout"),
                 "--backend", backend]) == 0
    for suf in ("D", "SI", "TD", "INV"):
        text_out = open(os.path.join(d, f"text_{suf}")).read()
        bam_out = open(os.path.join(d, f"bamout_{suf}")).read()
        assert bam_out == text_out, f"_{suf} differs"
    assert "ChrID" in open(os.path.join(d, "text_D")).read()


@pytest.mark.parametrize("backend", ["numpy", "fused"])
def test_bam_ref_coverage_columns(tmp_path, backend):
    """Proper pairs around an event produce real coverage numbers in the
    per-sample report columns (UpdateRefReadCoverage, pindel.cpp:1272)."""
    d, fa, bam, txt, cfg = _scene_bam_and_text(tmp_path, seed=4)
    from pindel_tpu.testing.simulate import standard_scene
    ref, _, _ = standard_scene(seed=4, chrom_len=60_000,
                               kinds=["DEL", "SI", "DEL", "DI", "INV",
                                      "TD"],
                               reads_per_event=8, n_noise=6)
    # rebuild the same scene pairs from the text file, add clean proper
    # pairs tiling the genome, and write one coordinate-sorted BAM
    scene_recs = []
    lines = open(txt).read().splitlines()
    for i in range(0, len(lines), 3):
        name, seq, meta = lines[i], lines[i + 1], lines[i + 2].split()
        dstr, pos, mq = meta[0], int(meta[2]), int(meta[3])
        anchor_pos = pos if dstr == "+" else pos - 100
        scene_recs.extend(anchored_pair(name[1:-2], anchor_pos, seq, ref,
                                        anchor_reverse=(dstr == "-"), mapq=mq))
    extra = []
    for start in range(0, 59_600, 200):
        extra.append(BamRecord(
            f"pp{start}", FLAG_PAIRED, 0, start, 60, [(100, "M")],
            0, start + 300, 400, ref[start:start + 100], tags={"NM": 0}))
        extra.append(BamRecord(
            f"pp{start}", FLAG_PAIRED | FLAG_REVERSE | FLAG_READ2,
            0, start + 300, 60, [(100, "M")], 0, start, -400,
            ref[start + 300:start + 400], tags={"NM": 0}))
    merged = sorted(scene_recs + extra, key=lambda r: r.pos)
    bam3 = os.path.join(d, "cov.bam")
    write_bam(bam3, [("chrT", len(ref))], merged)
    cfg3 = os.path.join(d, "cov.cfg")
    with open(cfg3, "w") as fh:
        fh.write(f"{bam3}\t500\tS1\n")
    from pindel_tpu.__main__ import main
    assert main(["-f", fa, "-i", cfg3, "-o", os.path.join(d, "cov"),
                 "--backend", backend]) == 0
    d_out = open(os.path.join(d, "cov_D")).read()
    assert "ChrID" in d_out
    # sample column format: "S1 <cov_start> <cov_end> ..." with real
    # (nonzero) coverage from the tiling proper pairs
    saw = False
    for line in d_out.splitlines():
        if "\tS1 " in line:
            cov_start = int(line.split("\tS1 ")[1].split()[0])
            assert cov_start > 0
            saw = True
            break
    assert saw


def test_bam_config_parse(tmp_path):
    p = tmp_path / "c.txt"
    p.write_text("/x/a.bam 300 sampleA\n/x/b.bam 400 sampleB\n")
    entries = read_bam_config(str(p))
    assert [(e.insert_size, e.tag) for e in entries] == [
        (300, "sampleA"), (400, "sampleB")]
