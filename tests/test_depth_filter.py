"""Germline read-depth filter (-N) and depth-module tests.

Scene: a 300 bp tandem duplication evidenced by split reads at the copy
junction, over a uniform background of concordant reference pairs.  The
background coverage is NOT doubled inside the duplicated segment, so the
relative-coverage signal stays ~2.0 < 2.7 and `-N` must drop the TD —
while the run without `-N` reports it.  Both runs are compared
byte-for-byte against the compiled reference.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

from pindel_tpu.testing.bamwriter import (  # noqa: E402
    FLAG_MREVERSE, FLAG_MUNMAP, FLAG_PAIRED, FLAG_READ1, FLAG_READ2,
    FLAG_REVERSE, FLAG_UNMAP, BamRecord, write_bam)
from make_fai import make_fai  # noqa: E402

from test_golden_vs_reference import oracle  # noqa: E402,F401

_RC = str.maketrans("ACGTN", "TGCAN")

S, E, L = 5000, 8000, 3000         # TD of ref[S:E), size L
READ, FRAG = 100, 300


def _rc(s):
    return s.translate(_RC)[::-1]


def _pair(name, p1, seq1, p2, seq2, m1, m2):
    """One fragment: read1 fwd (+) and read2 reverse; unmapped reads
    keep the raw sequenced (reverse-complement) bases."""
    isize = (p2 + READ) - p1 if (m1 and m2) else 0
    f1 = FLAG_PAIRED | FLAG_READ1
    f2 = FLAG_PAIRED | FLAG_READ2
    if m2:
        f2 |= FLAG_REVERSE
        f1 |= FLAG_MREVERSE
    if not m1:
        f1 |= FLAG_UNMAP
        f2 |= FLAG_MUNMAP
    if not m2:
        f2 |= FLAG_UNMAP
        f1 |= FLAG_MUNMAP
    pos1 = p1 if m1 else p2
    pos2 = p2 if m2 else p1
    return [
        BamRecord(name, f1, 0, pos1, 60 if m1 else 0,
                  [(READ, "M")] if m1 else [], 0, pos2, isize, seq1,
                  tags={"NM": 0} if m1 else {}),
        BamRecord(name, f2, 0, pos2, 60 if m2 else 0,
                  [(READ, "M")] if m2 else [], 0, pos1, -isize,
                  seq2 if m2 else _rc(seq2),
                  tags={"NM": 0} if m2 else {}),
    ]


def _td_scene(tmp_path):
    rng = np.random.default_rng(7)
    ref = "".join(rng.choice(list("ACGT"), size=40_000))
    alt = ref[:E] + ref[S:E] + ref[E:]
    records = []
    # uniform background from the reference haplotype (~1.3x coverage)
    for g in range(0, len(ref) - FRAG, 150):
        records += _pair(f"bg_{g}", g, ref[g:g + READ],
                         g + FRAG - READ, ref[g + FRAG - READ:g + FRAG],
                         True, True)
    # junction fragments from the ALT haplotype: one read straddles the
    # copy junction (ALT position E) and is unmapped; its mate anchors it
    # few enough junction reads that they don't lift the region's own
    # coverage past the 2.7 confirmation threshold
    for f in range(E - 280, E - 240, 10):     # read2 straddles E
        records += _pair(f"tdA_{f}", f, alt[f:f + READ],
                         f + FRAG - READ,
                         alt[f + FRAG - READ:f + FRAG], True, False)
    for f in range(E - 40, E, 10):            # read1 straddles E
        p2 = f + FRAG - READ                  # inside the second copy
        records += _pair(f"tdB_{f}", f, alt[f:f + READ],
                         S + (p2 - E), alt[p2:p2 + READ], False, True)
    records.sort(key=lambda r: (r.tid, r.pos))
    d = str(tmp_path)
    fa = os.path.join(d, "ref.fa")
    with open(fa, "w") as fh:
        fh.write(">chrT\n")
        for i in range(0, len(ref), 70):
            fh.write(ref[i:i + 70] + "\n")
    make_fai(fa)
    bam = os.path.join(d, "td.bam")
    write_bam(bam, [("chrT", len(ref))], records)
    open(bam + ".bai", "w").close()
    cfg = os.path.join(d, "cfg.txt")
    with open(cfg, "w") as fh:
        fh.write(f"{bam}\t{FRAG}\tS1\n")
    return d, fa, cfg, bam


def _run(d, fa, cfg, oracle_bin, tag, extra, backend="numpy"):
    r = subprocess.run([oracle_bin, "-f", fa, "-i", cfg,
                        "-o", os.path.join(d, f"gold{tag}"), *extra],
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-2000:]
    from pindel_tpu.__main__ import main
    assert main(["-f", fa, "-i", cfg, "-o", os.path.join(d, f"ours{tag}"),
                 "--backend", backend, *extra]) == 0
    for suf in ("TD", "D", "SI", "INV"):
        gold = open(os.path.join(d, f"gold{tag}_{suf}")).read()
        ours = open(os.path.join(d, f"ours{tag}_{suf}")).read()
        assert ours == gold, f"_{suf} differs with {extra}"
    return open(os.path.join(d, f"gold{tag}_TD")).read()


@pytest.mark.parametrize("backend", ["numpy", "fused"])
def test_normal_samples_td_filter(tmp_path, oracle, backend):  # noqa: F811
    d, fa, cfg, _ = _td_scene(tmp_path)
    # -x 4 so the far-end ladder (128*4^k) reaches across the 3 kb copy
    td_plain = _run(d, fa, cfg, oracle, "p", ["-x", "4"],
                    backend=backend)
    td_filtered = _run(d, fa, cfg, oracle, "n", ["-x", "4", "-N"],
                       backend=backend)
    assert "\tTD " in td_plain          # the TD is actually called
    assert td_filtered != td_plain      # ...and -N actually filtered it
    assert "\tTD " not in td_filtered


def test_depth_module_semantics(tmp_path):
    from pindel_tpu.bam import BamReader
    from pindel_tpu.depth import bam2depth, get_relative_coverage_internal
    ref_len = 4000
    recs = [
        # 100M at 1000, mapq 60
        BamRecord("a", 0, 0, 1000, 60, [(100, "M")], -1, -1, 0, "A" * 100),
        # 40M20D40M at 1200: the deletion hole must not count
        BamRecord("b", 0, 0, 1200, 60, [(40, "M"), (20, "D"), (40, "M")],
                  -1, -1, 0, "A" * 80),
        # low mapq: excluded
        BamRecord("c", 0, 0, 1000, 5, [(100, "M")], -1, -1, 0, "A" * 100),
    ]
    bam = str(tmp_path / "d.bam")
    write_bam(bam, [("chrD", ref_len)], recs)
    br = BamReader(bam)
    (avg,) = bam2depth([br], "chrD", 1000, 1300)
    assert avg == (100 + 80) / 300.0
    # region [1000,1300) vs flanks [700,1000) + [1300,1600) (both empty)
    (sig,) = get_relative_coverage_internal("chrD", ref_len, 1000, 1300,
                                            [br])
    assert sig == -1.0                  # flanks sum to zero
