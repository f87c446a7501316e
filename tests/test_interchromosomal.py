"""Interchromosomal (INT) event detection: translocation reads whose far
end lies on another chromosome, guided there by an interchromosomal
BreakDancer call (BAM input activates the BD windows)."""
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

from pindel_tpu.testing.bamwriter import write_bam  # noqa: E402
from make_fai import make_fai  # noqa: E402
from pindel_tpu.testing.bamwriter import anchored_pair  # noqa: E402

from pindel_tpu.testing.simulate import random_seq, rc, write_fasta  # noqa: E402

import pytest  # noqa: E402


@pytest.mark.parametrize("backend", ["numpy", "fused", "mesh"])
def test_translocation_int_report(tmp_path, backend):
    rng = np.random.default_rng(12)
    ref_a = random_seq(rng, 30_000)
    ref_b = random_seq(rng, 30_000)
    d = str(tmp_path)
    fa = os.path.join(d, "ref.fa")
    write_fasta(fa, [("chrA", ref_a), ("chrB", ref_b)])
    make_fai(fa)

    # translocation: chrA:10000 joins chrB:20000; breakpoint-crossing
    # fragments = chrA left flank + chrB right part
    bp_a, bp_b = 10_000, 20_000
    recs = []
    refs = [("chrA", len(ref_a)), ("chrB", len(ref_b))]
    for k in range(8):
        flank = int(rng.integers(40, 60))
        frag = ref_a[bp_a - flank: bp_a] + ref_b[bp_b: bp_b + 100 - flank]
        # '+' anchor on chrA upstream of the breakpoint
        gap = int(rng.integers(60, 300))
        anchor_pos = bp_a - flank - gap - 100
        recs.extend(anchored_pair(f"t{k}", anchor_pos, rc(frag), ref_a))
    recs.sort(key=lambda r: r.pos)
    bam = os.path.join(d, "reads.bam")
    write_bam(bam, refs, recs)
    cfg = os.path.join(d, "bam.cfg")
    with open(cfg, "w") as fh:
        fh.write(f"{bam}\t500\tS1\n")
    bd = os.path.join(d, "calls.bd")
    with open(bd, "w") as fh:
        fh.write(f"chrA\t{bp_a}\t8+0-\tchrB\t{bp_b}\t0+8-\tCTX\t-1\t99\n")

    from pindel_tpu.__main__ import main
    assert main(["-f", fa, "-i", cfg, "-o", os.path.join(d, "out"),
                 "-b", bd, "-I", "--backend", backend]) == 0
    int_text = open(os.path.join(d, "out_INT")).read()
    assert "Anchor + chrA" in int_text and "chrB" in int_text
    assert "support:" in int_text
    final = open(os.path.join(d, "out_INT_final")).read()
    assert "chrA" in final and "chrB" in final

    # without -I: no INT lines, empty final
    assert main(["-f", fa, "-i", cfg, "-o", os.path.join(d, "noi"),
                 "-b", bd, "--backend", backend]) == 0
    assert not os.path.exists(os.path.join(d, "noi_INT")) \
        or open(os.path.join(d, "noi_INT")).read() == ""
    assert open(os.path.join(d, "noi_INT_final")).read() == ""
