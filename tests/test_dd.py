"""DD/MEI (-q) mode tests: golden vs the reference oracle plus native
seqmatch unit tests.

The synthetic scene plants a dispersed duplication (a 500 bp segment
copied from a donor locus >MIN_DD_MAP_DISTANCE away into an acceptor
site) and samples paired-end reads from the ALT haplotype: pairs
straddling the gap become discordant clusters, reads straddling the
insertion point become split reads anchored by their mapped mates — so
both the cluster-estimation and the split-read breakpoint paths of
get_breakpoints run.
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


def _rc(s):
    return s.translate(_RC)[::-1]


P, L, DONOR = 5000, 500, 20000
READ, FRAG, INS = 100, 300, 300


def _dd_scene(tmp_path):
    rng = np.random.default_rng(42)
    ref = "".join(rng.choice(list("ACGT"), size=40_000))
    alt = ref[:P] + ref[DONOR:DONOR + L] + ref[P:]

    def project(start):
        """ALT coordinate -> (ref pos, mapped) for a READ-long read."""
        if start + READ <= P:
            return start, True
        if start >= P and start + READ <= P + L:
            return DONOR + (start - P), True
        if start >= P + L:
            return start - L, True
        return -1, False

    records = []
    for f in range(4500, 5500, 10):
        r1_seq = alt[f:f + READ]                     # forward read
        r2_frag = alt[f + FRAG - READ:f + FRAG]
        p1, m1 = project(f)
        p2, m2 = project(f + FRAG - READ)
        if not m1 and not m2:
            continue
        name = f"dd_{f}"
        pos1 = p1 if m1 else p2
        pos2 = p2 if m2 else p1
        isize = 0
        if m1 and m2:
            isize = (max(p1, p2) + READ) - min(p1, p2)
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
        records.append(BamRecord(
            name, f1, 0, pos1, 60 if m1 else 0,
            [(READ, "M")] if m1 else [], 0, pos2,
            isize if m1 and m2 and p1 <= p2 else -isize,
            r1_seq, tags={"NM": 0} if m1 else {}))
        # mapped reverse reads store the reference-forward sequence;
        # unmapped reads store the raw sequenced (RC) bases
        records.append(BamRecord(
            name, f2, 0, pos2, 60 if m2 else 0,
            [(READ, "M")] if m2 else [], 0, pos1,
            -isize if m1 and m2 and p1 <= p2 else isize,
            r2_frag if m2 else _rc(r2_frag),
            tags={"NM": 0} if m2 else {}))
    records.sort(key=lambda r: (r.tid, r.pos))
    d = str(tmp_path)
    fa = os.path.join(d, "ref.fa")
    with open(fa, "w") as fh:
        fh.write(">chrT\n")
        for i in range(0, len(ref), 70):
            fh.write(ref[i:i + 70] + "\n")
    make_fai(fa)
    bam = os.path.join(d, "dd.bam")
    write_bam(bam, [("chrT", len(ref))], records)
    open(bam + ".bai", "w").close()     # reference checks file presence
    cfg = os.path.join(d, "cfg.txt")
    with open(cfg, "w") as fh:
        fh.write(f"{bam}\t{INS}\tS1\n")
    return d, fa, cfg


def _run_both(d, fa, cfg, oracle_bin, backend="numpy", extra=()):
    r = subprocess.run([oracle_bin, "-f", fa, "-i", cfg,
                        "-o", os.path.join(d, "gold"), "-q", *extra],
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-500:]
    from pindel_tpu.__main__ import main
    assert main(["-f", fa, "-i", cfg, "-o", os.path.join(d, "ours"),
                 "-q", "--backend", backend, *extra]) == 0
    gold = open(os.path.join(d, "gold_DD")).read()
    ours = open(os.path.join(d, "ours_DD")).read()
    assert ours == gold, f"_DD differs:\ngold:\n{gold[:1500]}\n" \
                         f"ours:\n{ours[:1500]}"
    return gold


def test_dd_synthetic_scene(tmp_path, oracle):  # noqa: F811
    d, fa, cfg = _dd_scene(tmp_path)
    gold = _run_both(d, fa, cfg, oracle)
    assert "\tDD\t" in gold          # events actually called


def test_dd_split_read_breakpoints(tmp_path, oracle):  # noqa: F811
    # a narrow MIN_DD_MAP_DISTANCE keeps the local-alignment window free
    # of chance 15-mer matches, so split-read breakpoints survive
    d, fa, cfg = _dd_scene(tmp_path)
    gold = _run_both(d, fa, cfg, oracle,
                     extra=["--MIN_DD_MAP_DISTANCE", "1000"])
    assert "\tDD\t" in gold
    assert "Reference: " in gold     # split-read support path exercised


@pytest.mark.parametrize("backend", ["numpy", "fused"])
def test_dd_demo_golden(tmp_path, oracle, backend):  # noqa: F811
    demo = "/root/reference/demo/simulated_MEI"
    if not os.path.exists(os.path.join(demo, "aln.sorted.bam")):
        pytest.skip("demo MEI data not available")
    d = str(tmp_path)
    import shutil
    for f in ("reference.fa", "aln.sorted.bam", "aln.sorted.bam.bai"):
        shutil.copy(os.path.join(demo, f), d)
    fa = os.path.join(d, "reference.fa")
    make_fai(fa)
    cfg = os.path.join(d, "cfg.txt")
    with open(cfg, "w") as fh:
        fh.write(f"{os.path.join(d, 'aln.sorted.bam')}\t500\tMEI\n")
    gold = _run_both(d, fa, cfg, oracle, backend=backend)
    assert "\tDD\t" in gold


def test_contains_subseq_semantics():
    from pindel_tpu.config import Settings
    from pindel_tpu.dd import contains_subseq, contains_subseq_any_strand
    maxmm = Settings().max_mismatch()
    rng = np.random.default_rng(3)
    db = "".join(rng.choice(list("ACGT"), size=2000))
    q = db[700:740]
    assert contains_subseq(q, db, 15, maxmm)
    assert contains_subseq_any_strand(_rc(q), db, 15, maxmm)
    # a 40bp query from another universe should not align
    other = "".join(np.random.default_rng(99).choice(list("ACGT"), 40))
    # (may still match by chance in theory; this seed does not)
    assert not contains_subseq(other, db, 15, maxmm) or len(db) < 40
