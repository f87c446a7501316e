"""Golden tests for BreakDancer evidence input (-b) and confirmation
output (-Q) vs the reference oracle, plus RP-machinery unit tests."""
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

from make_fai import make_fai  # noqa: E402
from test_golden_vs_reference import _first_diff, oracle  # noqa: F401,E402


def _big_del_scene(tmp_path, seed=8, del_size=6000):
    """A deletion too large for the default geometric far-end ladder
    (spans 64/256/1024 for -x 2), only findable via BD windows."""
    import numpy as np

    from pindel_tpu.testing.simulate import (Event, Simulator, SimReads,
                                             random_seq, write_fasta)
    rng = np.random.default_rng(seed)
    ref = random_seq(rng, 60_000)
    sim = Simulator(rng)
    out = SimReads([], [], [])
    events = [Event("DEL", "chrT", 20_000, size=del_size),
              Event("DEL", "chrT", 40_000, size=100)]
    for ev in events:
        sim.reads_for_event(ref, "chrT", ev, 10, out)
    sim.ref_noise_reads(ref, "chrT", 6, out)
    d = str(tmp_path)
    fa = os.path.join(d, "ref.fa")
    write_fasta(fa, [("chrT", ref)])
    make_fai(fa)
    txt = os.path.join(d, "reads.txt")
    out.write(txt)
    bd = os.path.join(d, "calls.bd")
    with open(bd, "w") as fh:
        fh.write("#header line\n")
        fh.write(f"chrT\t{20_000}\t20+20-\tchrT\t{20_000 + del_size}"
                 f"\t18+19-\tDEL\t{del_size}\t99\n")
        # a malformed-looking but >=6-field numeric line is accepted
        fh.write(f"chrT\t{39_900}\t5\tchrT\t{40_600}\t6\n")
    return d, fa, txt, bd, events


def _run_both(d, fa, txt, extra_gold, extra_ours, suffixes,
              backend="numpy"):
    r = subprocess.run(["/tmp/pindel_oracle/pindel", "-f", fa, "-p", txt,
                        "-o", os.path.join(d, "gold"), "-s", *extra_gold],
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-1500:]
    from pindel_tpu.__main__ import main
    assert main(["-f", fa, "-p", txt, "-o", os.path.join(d, "ours"),
                 "-s", "--backend", backend, *extra_ours]) == 0
    for suf in suffixes:
        gold = open(os.path.join(d, f"gold_{suf}")).read()
        ours = open(os.path.join(d, f"ours_{suf}")).read()
        assert ours == gold, (f"_{suf} differs:\n"
                              + "\n".join(_first_diff(gold, ours)))


@pytest.mark.parametrize("backend", ["numpy", "fused"])
def test_bd_with_text_input_is_inert_like_reference(tmp_path, oracle,
                                                    backend):
    """Reference quirk (0.2.5b9): external BD events only reach
    loadRegion via UpdateBD (m_bdEvents = m_bdEvents_external,
    bddata.cpp:648), and UpdateBD runs only for BAM input
    (pindel.cpp:1837-1847) — so -b with pindel-text input guides
    nothing.  Both implementations must agree bit-for-bit on that."""
    d, fa, txt, bd, events = _big_del_scene(tmp_path)
    q_gold = os.path.join(d, "gold_Q.txt")
    q_ours = os.path.join(d, "ours_Q.txt")
    _run_both(d, fa, txt, ["-b", bd, "-Q", q_gold],
              ["-b", bd, "-Q", q_ours], ["CloseEndMapped", "D", "SI",
                                         "TD", "INV"], backend=backend)
    with_bd = open(os.path.join(d, "gold_D")).read()
    assert f"D {6000}" not in with_bd      # the quirk: BD didn't help
    gold = open(q_gold).read() if os.path.exists(q_gold) else ""
    ours = open(q_ours).read() if os.path.exists(q_ours) else ""
    assert ours == gold == ""


@pytest.mark.parametrize("backend", ["numpy", "fused", "mesh"])
def test_bd_guided_far_end_bam_input(tmp_path, backend):
    """With BAM input, UpdateBD activates the external BD windows each
    window, so the 6 kb deletion (beyond the -x 2 geometric ladder) is
    found — and -Q confirms it against the BD call."""
    from pindel_tpu.testing.bamwriter import anchored_pair
    from pindel_tpu.testing.bamwriter import write_bam

    d, fa, txt, bd, events = _big_del_scene(tmp_path)
    from pindel_tpu.testing.simulate import standard_scene  # for ref only
    ref = open(fa).read().split("\n", 1)[1].replace("\n", "")
    lines = open(txt).read().splitlines()
    recs = []
    for i in range(0, len(lines), 3):
        name, seq, meta = lines[i], lines[i + 1], lines[i + 2].split()
        dstr, pos, mq = meta[0], int(meta[2]), int(meta[3])
        anchor_pos = pos if dstr == "+" else pos - 100
        if anchor_pos < 0 or anchor_pos + 100 > len(ref):
            continue
        recs.extend(anchored_pair(name[1:-2], anchor_pos, seq, ref,
                                  anchor_reverse=(dstr == "-"), mapq=mq))
    recs.sort(key=lambda r: r.pos)
    bam = os.path.join(d, "reads.bam")
    write_bam(bam, [("chrT", len(ref))], recs)
    cfg = os.path.join(d, "bam.cfg")
    with open(cfg, "w") as fh:
        fh.write(f"{bam}\t500\tS1\n")
    q_out = os.path.join(d, "bd_q.txt")
    from pindel_tpu.__main__ import main
    assert main(["-f", fa, "-i", cfg, "-o", os.path.join(d, "bam"),
                 "-b", bd, "-Q", q_out, "--backend", backend]) == 0
    d_out = open(os.path.join(d, "bam_D")).read()
    assert f"D {6000}" in d_out
    # -Q stays empty: the reference's isBreakDancerEvent compares a
    # window-relative offset against absolute window coordinates
    # (haveCommonBDEvent call, bddata.cpp:987-989 vs encompasses,
    # pindel.cpp:328-331), so confirmations essentially never fire;
    # we mirror that bug for parity
    assert not os.path.exists(q_out) or open(q_out).read() == ""
    # and without -b the deletion is out of geometric reach
    assert main(["-f", fa, "-i", cfg, "-o", os.path.join(d, "nobd"),
                 "--backend", backend]) == 0
    assert f"D {6000}" not in open(os.path.join(d, "nobd_D")).read()


def test_rp_modify_and_summarize_unit():
    """RP clustering pinning: 6 identical discordant pairs cross the
    support cutoff (5), 2 do not."""
    from pindel_tpu.bddata import RPRead, modify_rp, summarize

    # ModifyRP sorts descending by OriginalPosA, and Summarize's final
    # loop runs to GoodIndex.size()-1 — the LAST good cluster's Report is
    # never set (reference quirk, bddata.cpp:532-556).  Place the
    # high-support cluster first (higher position).
    reads = []
    for i in range(6):
        reads.append(RPRead(chr_name_a="c", chr_name_b="c", da="+",
                            db="-", pos_a=30000, pos_b=44000,
                            original_pos_a=30000, original_pos_b=44000,
                            insert_size=300, read_length=100, tag="S1",
                            tags=["S1"]))
    for i in range(2):
        reads.append(RPRead(chr_name_a="c", chr_name_b="c", da="+",
                            db="-", pos_a=1000, pos_b=9000,
                            original_pos_a=1000, original_pos_b=9000,
                            insert_size=300, read_length=100, tag="S2",
                            tags=["S2"]))
    reads.sort(key=lambda r: (r.pos_a, r.pos_b))
    modify_rp(reads)
    summarize(reads)
    reported = [r for r in reads if r.report]
    assert len(reported) == 1
    assert reported[0].num_identical == 6
    assert reported[0].tags == ["S1"] * 6


def test_rp_discovery_from_bam(tmp_path):
    """End-to-end: discordant pairs in a BAM produce a _RP record and a
    BD-like search window."""
    from pindel_tpu.testing.bamwriter import (
        FLAG_MREVERSE, FLAG_PAIRED, FLAG_READ1, FLAG_READ2, FLAG_REVERSE,
        BamRecord, write_bam)

    from pindel_tpu.bam import BamReader
    ref_len = 60_000
    recs = []
    # 6 discordant pairs (same strand '+/+' -> discordant)
    for k in range(6):
        recs.append(BamRecord(f"d{k}", FLAG_PAIRED, 0, 10_000, 60,
                              [(100, "M")], 0, 20_000, 10_100,
                              "A" * 100, tags={"NM": 0}))
        recs.append(BamRecord(f"d{k}", FLAG_PAIRED | FLAG_READ2, 0,
                              20_000, 60, [(100, "M")], 0, 10_000,
                              -10_100, "C" * 100, tags={"NM": 0}))
    recs.sort(key=lambda r: r.pos)
    bam = str(tmp_path / "rp.bam")
    write_bam(bam, [("chrT", ref_len)], recs)
    br = BamReader(bam)
    same, inter = br.collect_rp("chrT", 0, ref_len, 300, "S1")
    # each record of each pair reports (both mates mapped & discordant)
    assert len(same) == 12 and not inter
    from pindel_tpu.bddata import BDData
    import io
    bd = BDData()
    out = io.StringIO()
    bd.update_bd(same, inter, out, False)
    rp_text = out.getvalue()
    assert "Support:" in rp_text and "S1" in rp_text
    assert len(bd.events) >= 2
    # rasterize + query: close ends near the first coordinate see a
    # search window near the second
    from pindel_tpu.genome import SPACER
    bd.load_region("chrT", SPACER, SPACER + ref_len)
    cluster = bd.cluster_for(SPACER + 10_050)
    assert cluster, "expected a BD search window for the RP cluster"
    assert any(s <= SPACER + 20_000 <= e for _, s, e in cluster)


def test_modify_rp_native_matches_python_fallback():
    """The native merge core (native/rp.cpp) and the vectorized Python
    fallback must produce identical post-merge coordinates."""
    import numpy as np

    from pindel_tpu import bddata as bd

    def mk(rng, n):
        reads = []
        for k in range(n):
            base = int(rng.integers(1000, 200_000))
            d = int(rng.integers(50, 2500))
            r = bd.RPRead(
                chr_name_a="chrT", chr_name_b="chrT",
                da=rng.choice(["+", "-"]), db=rng.choice(["+", "-"]),
                pos_a=base, pos_b=base + d,
                original_pos_a=base, original_pos_b=base + d,
                insert_size=int(rng.integers(150, 600)),
                read_length=int(rng.integers(36, 101)),
                tag="s0", tags=["s0"])
            reads.append(r)
        return reads

    rng = np.random.default_rng(11)
    for trial in range(4):
        n = int(rng.integers(5, 160))
        seed_reads = mk(rng, n)
        import copy
        a = [copy.copy(r) for r in seed_reads]
        b = [copy.copy(r) for r in seed_reads]
        bd.modify_rp(a)                       # native path
        saved = bd._rp_lib
        try:
            bd._rp_lib = None

            def _fail():
                raise RuntimeError("force python fallback")
            orig = bd._native_rp
            bd._native_rp = _fail
            bd.modify_rp(b)                   # python fallback
        finally:
            bd._native_rp = orig
            bd._rp_lib = saved
        for ra, rb in zip(a, b):
            assert (ra.pos_a, ra.pos_a1, ra.pos_b, ra.pos_b1,
                    ra.visited) == \
                   (rb.pos_a, rb.pos_a1, rb.pos_b, rb.pos_b1, rb.visited), \
                trial
