"""Genotyping (-g/-Y) semantics pinned by unit tests.

The reference ships this module with its call-site disabled
(pindel.cpp:1733-1736), so there is no golden binary path to diff
against; these tests pin the documented behavior of
genotyping.cpp:39-380 on synthetic BAMs.
"""
import os
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

from pindel_tpu.testing.bamwriter import (  # noqa: E402
    FLAG_MREVERSE, FLAG_PAIRED, FLAG_READ1, FLAG_READ2, FLAG_REVERSE,
    BamRecord, write_bam)
from make_fai import make_fai  # noqa: E402

from pindel_tpu.genotyping import (GenotypingSV, genotype_del_rp,  # noqa: E402
                                   load_ploidy, median_and_mad,
                                   read_sv_file, run_genotyping_files)


def test_read_sv_file(tmp_path):
    p = tmp_path / "svs.txt"
    p.write_text("DEL chr1 10000 50 chr1 5000 100\n"
                 "DUP chr2 20000 100 chr2 30000 100 INV chr1 1 1 chr2 2 2\n")
    svs = read_sv_file(str(p))
    assert len(svs) == 3
    # same-chromosome out-of-order positions are swapped
    assert (svs[0].pos_a, svs[0].pos_b) == (5000, 10000)
    assert (svs[0].ci_a, svs[0].ci_b) == (50, 100)
    assert svs[2].type == "INV" and svs[2].chr_b == "chr2"


def test_load_ploidy(tmp_path):
    p = tmp_path / "ploidy.txt"
    p.write_text("chr1 2\nchrX 1 trailing junk\n")
    assert load_ploidy(str(p)) == {"chr1": 2, "chrX": 1}


def test_median_and_mad():
    # sorted[mid] convention (size/2, genotyping.cpp:216-218)
    d = np.array([100, 300, 200, 400], dtype=np.int64)
    median, mad = median_and_mad(d)
    assert median == 300                       # sorted[4//2]
    diffs = sorted(abs(x - 300) for x in d)    # [0,100,100,200]
    assert mad == diffs[2]


def _pair_records(qname, ref_len, pos_a, pos_b, qual=60, seq_len=50):
    """A forward/reverse pair with the given 0-based positions."""
    seq = "A" * seq_len
    isize = (pos_b + seq_len) - pos_a
    cig = [(seq_len, "M")]
    r1 = BamRecord(qname=qname, flag=FLAG_PAIRED | FLAG_READ1 | FLAG_MREVERSE,
                   tid=0, pos=pos_a, mapq=qual, cigar=cig,
                   mate_tid=0, mate_pos=pos_b, tlen=isize, seq=seq)
    r2 = BamRecord(qname=qname, flag=FLAG_PAIRED | FLAG_READ2 | FLAG_REVERSE,
                   tid=0, pos=pos_b, mapq=qual, cigar=cig,
                   mate_tid=0, mate_pos=pos_a, tlen=-isize, seq=seq)
    return [r1, r2]


@pytest.fixture()
def del_scene(tmp_path):
    """A 60 kb chromosome with a deletion at [20000, 28000): ALT pairs
    span it with inflated insert distance; REF pairs bracket each
    breakpoint at normal distance."""
    ref_len = 60_000
    recs = []
    # REF pairs around breakpoint A (20000) and B (28000), distance ~500
    for i in range(6):
        recs += _pair_records(f"refA_{i}", ref_len, 19700 + i, 20150 + i)
        recs += _pair_records(f"refB_{i}", ref_len, 27700 + i, 28150 + i)
    # ALT pairs spanning the whole deletion: distance ~8500
    for i in range(4):
        recs += _pair_records(f"alt_{i}", ref_len, 19700 + i, 28200 + i)
    # low-quality pair that must be ignored (MQ < 20)
    recs += _pair_records("lowq", ref_len, 19700, 28200, qual=5)
    recs.sort(key=lambda r: r.pos)
    bam = str(tmp_path / "gt.bam")
    write_bam(bam, [("chrT", ref_len)], recs)
    fa = str(tmp_path / "ref.fa")
    with open(fa, "w") as fh:
        fh.write(">chrT\n")
        fh.write("A" * ref_len + "\n")
    make_fai(fa)
    cfg = str(tmp_path / "cfg.txt")
    with open(cfg, "w") as fh:
        fh.write(f"{bam}\t250\tS1\n")
    return fa, bam, cfg


def test_genotype_del_rp(del_scene):
    fa, bam, cfg = del_scene
    from pindel_tpu.bam import BamReader
    reader = BamReader(bam)
    sv = GenotypingSV("DEL", "chrT", 20000, 100, "chrT", 28000, 100)
    gt = genotype_del_rp(reader, 250, sv)
    # collected pairs: |isize| > l_qseq + 2*250 = 550 -> REF pairs
    # (distance ~500+50=550... isize = pos_b+50-pos_a = 500) are NOT
    # collected; only the ALT pairs (isize ~8550) are.  With only ALT
    # distances the median ~8500, cutoff ~8500+5*MAD -> the ALT pairs
    # count as REF (distance <= cutoff) bracketing both breakpoints.
    assert gt is not None
    # all informative pairs bracket A, B and the whole event at
    # distance <= cutoff: REF_A = REF_B = 4, ALT = 0 -> genotype 2.0
    assert gt == pytest.approx(2.0)


def test_genotype_del_rp_mixed_distances(tmp_path):
    """REF/ALT separation when both populations pass the collect gate."""
    ref_len = 60_000
    recs = []
    # "short" discordant pairs (distance ~1200) bracketing breakpoints
    for i in range(8):
        recs += _pair_records(f"refA_{i}", ref_len, 19300 + i, 20450 + i)
        recs += _pair_records(f"refB_{i}", ref_len, 27300 + i, 28450 + i)
    # long pairs spanning the event (distance ~8900)
    for i in range(4):
        recs += _pair_records(f"alt_{i}", ref_len, 19500 + i, 28350 + i)
    recs.sort(key=lambda r: r.pos)
    bam = str(tmp_path / "gt2.bam")
    write_bam(bam, [("chrT", ref_len)], recs)
    from pindel_tpu.bam import BamReader
    reader = BamReader(bam)
    sv = GenotypingSV("DEL", "chrT", 20000, 150, "chrT", 28000, 150)
    gt = genotype_del_rp(reader, 250, sv)
    # median distance ~1150 (16 short vs 4 long), MAD small; the long
    # pairs exceed cutoff -> ALT; short pairs bracket one breakpoint
    # REF_A=8, REF_B=8, ALT=4 -> 2*16/(16+8) = 1.333...
    assert gt == pytest.approx(2 * 16 / (16 + 8), abs=1e-6)


def test_run_genotyping_files(del_scene, tmp_path):
    fa, bam, cfg = del_scene
    svf = str(tmp_path / "svs.txt")
    with open(svf, "w") as fh:
        fh.write("DEL chrT 20000 100 chrT 28000 100\n"
                 "TD chrT 20000 100 chrT 20500 100\n")
    out = str(tmp_path / "out")
    assert run_genotyping_files(fa, cfg, svf, out) == 0
    lines = open(out + "_GT").read().splitlines()
    assert len(lines) == 2
    assert lines[0].startswith("DEL\tchrT\t20000")
    assert "RP" in lines[0] and "RD" in lines[0]
    assert lines[1].startswith("TD\tchrT")
    assert "RP" not in lines[1]                 # DUP/TD: RD only


def test_cli_genotyping(del_scene, tmp_path):
    fa, bam, cfg = del_scene
    svf = str(tmp_path / "svs.txt")
    with open(svf, "w") as fh:
        fh.write("DEL chrT 20000 100 chrT 28000 100\n")
    ploidy = str(tmp_path / "ploidy.txt")
    with open(ploidy, "w") as fh:
        fh.write("chrT 2\n")
    from pindel_tpu.__main__ import main
    out = str(tmp_path / "cli")
    assert main(["-f", fa, "-i", cfg, "-g", svf, "-Y", ploidy,
                 "-o", out]) == 0
    assert os.path.exists(out + "_GT")


def test_duplicate_sample_names(del_scene, tmp_path):
    fa, bam, cfg = del_scene
    cfg2 = str(tmp_path / "cfg2.txt")
    with open(cfg2, "w") as fh:
        fh.write(f"{bam}\t250\tS1\n{bam}\t250\tS1\n")
    svf = str(tmp_path / "svs.txt")
    with open(svf, "w") as fh:
        fh.write("DEL chrT 20000 100 chrT 28000 100\n")
    with pytest.raises(ValueError, match="same sample name"):
        run_genotyping_files(fa, cfg2, svf, str(tmp_path / "dup"))
