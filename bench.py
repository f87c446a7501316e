#!/usr/bin/env python
"""Benchmark: split-reads/s/chip vs reference pindel on the same scenes.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", ...}.

Scene 1 (primary metric): pindel-format reads → close/far pattern-growth
search → event detection → report files, 50k reads over 6 Mb.  Scene 2
(secondary, reported as scene2_* keys): BAM input with a BreakDancer
evidence file — the evidence-guided path where the window pipeline runs
sequentially (BD/RP state carries between windows).  Outputs are asserted
byte-identical before timing is reported.  The reference binary is built
from /root/reference with the htslib stub (tools/) and timed on this
host's CPU (its native habitat — it has no accelerator path; its -T
default of 1 thread is the BASELINE.md reads/s/core metric).  Ours runs
the JAX engine on the real chip with -T 4 host worker threads (the chip's
host cores are part of the chip budget).  Timing for ours is the
median of three warm runs — compile time is a one-off, reported
separately on stderr.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tools"))

# >=50k reads over >=5 Mb so the device is actually loaded.
# 300 planted SVs x 60 split reads (~36% of reads support an event, the
# rest are reference-matching "weird mates" that the whole-read-fit rule
# rejects after the full search — the same work mix both sides see).
N_EVENTS = 300
READS_PER_EVENT = 60
N_NOISE = 32_000
SCENE_KINDS = ["DEL", "SI", "DI", "INV", "TD"] * (N_EVENTS // 5)
CHROM_LEN = 6_000_000

# scene 2: BAM input + BreakDancer file (evidence-guided far-end windows;
# sequential window pipeline).  Smaller so total bench wall time stays
# bounded; includes deletions beyond the -x2 geometric ladder that only
# the BD windows can find.
S2_EVENTS = 100
S2_READS_PER_EVENT = 40
S2_NOISE = 8_000
S2_CHROM_LEN = 2_000_000
NUM_THREADS = 4


def build_scene(workdir: str):
    from make_fai import make_fai

    from pindel_tpu.testing.simulate import standard_scene, write_fasta
    ref, events, reads = standard_scene(
        seed=1234, chrom_len=CHROM_LEN, kinds=SCENE_KINDS,
        reads_per_event=READS_PER_EVENT, n_noise=N_NOISE,
        chrom="chrB")
    fa = os.path.join(workdir, "bench_ref.fa")
    write_fasta(fa, [("chrB", ref)])
    make_fai(fa)
    reads_txt = os.path.join(workdir, "bench_reads.txt")
    reads.write(reads_txt)
    return fa, reads_txt, len(reads.names)


def build_scene2(workdir: str):
    """BAM + BreakDancer scene: text scene converted to paired BAM
    records (anchor mate mapped, split mate unmapped), plus a BD file
    naming every planted event (the reference's -b input format)."""
    import numpy as np
    from make_fai import make_fai

    from pindel_tpu.testing.bamwriter import split_read_pairs, write_bam
    from pindel_tpu.testing.simulate import (Event, Simulator, SimReads,
                                             random_seq, write_fasta)

    rng = np.random.default_rng(4321)
    ref = random_seq(rng, S2_CHROM_LEN)
    sim = Simulator(rng)
    out = SimReads([], [], [])
    kinds = ["DEL", "SI", "DI", "INV", "TD"] * (S2_EVENTS // 5)
    step = (S2_CHROM_LEN - 100_000) // len(kinds)
    events = []
    bd_lines = ["#chr1\tpos1\tori1\tchr2\tpos2\tori2\ttype\tsize\tscore"]
    for i, kind in enumerate(kinds):
        pos = 50_000 + i * step
        size = int(rng.integers(60, 2500)) if kind != "SI" else \
            int(rng.integers(3, 20))
        ev = Event(kind, "chrB", pos, size=size)
        events.append(ev)
        sim.reads_for_event(ref, "chrB", ev, S2_READS_PER_EVENT, out)
        bd_lines.append(f"chrB\t{pos}\t20+20-\tchrB\t{pos + size}"
                        f"\t18+19-\t{kind}\t{size}\t99")
    sim.ref_noise_reads(ref, "chrB", S2_NOISE, out)
    fa = os.path.join(workdir, "bench2_ref.fa")
    write_fasta(fa, [("chrB", ref)])
    make_fai(fa)
    bd = os.path.join(workdir, "bench2.bd")
    with open(bd, "w") as fh:
        fh.write("\n".join(bd_lines) + "\n")
    recs = split_read_pairs(out, ref)
    bam = os.path.join(workdir, "bench2.bam")
    write_bam(bam, [("chrB", len(ref))], recs)
    # the oracle's htslib stub only checks index presence (hts_stub.cpp)
    open(bam + ".bai", "w").close()
    cfg = os.path.join(workdir, "bench2.cfg")
    with open(cfg, "w") as fh:
        fh.write(f"{bam}\t500\tS1\n")
    return fa, cfg, bd, len(recs) // 2


# both sides also emit LI, BP and the close-end checkpoint so the
# correctness gate covers every report type
EXTRA_FLAGS = ["-l", "-k", "-s"]


def build_oracle() -> bool:
    r = subprocess.run(
        [os.path.join(REPO, "tools", "build_reference_oracle.sh")],
        capture_output=True, text=True, timeout=900)
    if r.returncode != 0:
        print("oracle build failed:", r.stderr[-400:], file=sys.stderr)
        return False
    return True


def time_reference(args: list, workdir: str) -> float:
    t0 = time.time()
    r = subprocess.run(["/tmp/pindel_oracle/pindel", *args],
                       capture_output=True, text=True, timeout=1800)
    dt = time.time() - t0
    assert r.returncode == 0, r.stdout[-1000:]
    return dt


def run_ours(fa: str, reads_txt: str, out_prefix: str) -> float:
    from pindel_tpu.config import Settings
    from pindel_tpu.pipeline import run_files
    from pindel_tpu.profiling import g_fallback
    s = Settings()
    s.analyze_li = True                   # -l
    s.analyze_bp = True                   # -k
    s.report_close_mapped_reads = True    # -s
    s.num_threads = NUM_THREADS           # -T
    g_fallback.reset()
    t0 = time.time()
    run_files(fa, reads_txt, out_prefix, settings=s,
              backend="fused")
    dt = time.time() - t0
    if g_fallback.fallback:
        print(f"fused fallback: {g_fallback.fallback}/{g_fallback.total} "
              f"reads re-ran on the host oracle", file=sys.stderr)
    return dt


def run_ours_bam(fa: str, cfg: str, bd: str, out_prefix: str) -> float:
    from pindel_tpu.config import Settings
    from pindel_tpu.pipeline import run_files
    s = Settings()
    s.report_close_mapped_reads = True
    s.breakdancer_filename = bd
    s.num_threads = NUM_THREADS
    t0 = time.time()
    run_files(fa, None, out_prefix, settings=s, backend="fused",
              bam_config=cfg)
    return time.time() - t0


def diff_outputs(workdir: str, gold_prefix: str, ours_prefix: str,
                 suffixes) -> list:
    mismatches = []
    for suf in suffixes:
        gold = open(os.path.join(workdir, f"{gold_prefix}_{suf}")).read()
        ours = open(os.path.join(workdir, f"{ours_prefix}_{suf}")).read()
        if gold != ours:
            mismatches.append(suf)
    return mismatches


def main() -> int:
    import tempfile
    workdir = tempfile.mkdtemp(prefix="pindel_bench_")
    fa, reads_txt, n_reads = build_scene(workdir)
    print(f"scene 1: {n_reads} reads over {CHROM_LEN // 1000} kb",
          file=sys.stderr)
    if not build_oracle():
        return 1

    ref_dt = time_reference(
        ["-f", fa, "-p", reads_txt, "-o", os.path.join(workdir, "gold"),
         "-c", "ALL", *EXTRA_FLAGS], workdir)
    print(f"reference: {ref_dt:.2f}s  ({n_reads / ref_dt:.1f} reads/s)",
          file=sys.stderr)

    cold_dt = run_ours(fa, reads_txt, os.path.join(workdir, "ours_cold"))
    print(f"ours cold (incl. compile): {cold_dt:.2f}s", file=sys.stderr)
    # median of 5 warm runs
    warms = [run_ours(fa, reads_txt, os.path.join(workdir, "ours"))
             for _ in range(5)]
    warm_dt = statistics.median(warms)
    print(f"ours warm: median {warm_dt:.2f}s of {[f'{w:.2f}' for w in warms]}"
          f"  ({n_reads / warm_dt:.1f} reads/s)", file=sys.stderr)

    # correctness gate: byte-identical reports
    mismatches = diff_outputs(
        workdir, "gold", "ours",
        ("D", "SI", "TD", "INV", "LI", "BP", "CloseEndMapped"))
    if not open(os.path.join(workdir, "gold_D")).read():
        mismatches.append("EMPTY_GOLD")
    if mismatches:
        print(f"OUTPUT MISMATCH in {mismatches} — benchmark void",
              file=sys.stderr)
        print(json.dumps({"metric": "split-reads/s/chip", "value": 0.0,
                          "unit": "reads/s",
                          "vs_baseline": 0.0}))
        return 1

    # ---- scene 2: BAM + BreakDancer evidence (sequential window path)
    s2 = {}
    try:
        fa2, cfg2, bd2, n2 = build_scene2(workdir)
        print(f"scene 2 (BAM+BD): {n2} read pairs over "
              f"{S2_CHROM_LEN // 1000} kb", file=sys.stderr)
        ref2_dt = time_reference(
            ["-f", fa2, "-i", cfg2, "-b", bd2, "-o",
             os.path.join(workdir, "gold2"), "-c", "ALL", "-s"], workdir)
        print(f"reference scene2: {ref2_dt:.2f}s "
              f"({n2 / ref2_dt:.1f} reads/s)", file=sys.stderr)
        # untimed warm-up: scene 2's bucket shapes compile here, not in
        # the first timed run (median-of-3 should measure steady state)
        run_ours_bam(fa2, cfg2, bd2, os.path.join(workdir, "ours2_warm"))
        w2 = [run_ours_bam(fa2, cfg2, bd2, os.path.join(workdir, "ours2"))
              for _ in range(5)]
        warm2 = statistics.median(w2)
        print(f"ours scene2: median {warm2:.2f}s of "
              f"{[f'{w:.2f}' for w in w2]}", file=sys.stderr)
        mm2 = diff_outputs(workdir, "gold2", "ours2",
                           ("D", "SI", "TD", "INV", "CloseEndMapped"))
        if not open(os.path.join(workdir, "gold2_D")).read():
            mm2.append("EMPTY_GOLD")
        if mm2:
            print(f"scene2 OUTPUT MISMATCH in {mm2} — scene2 void",
                  file=sys.stderr)
            s2 = {"scene2_vs_baseline": 0.0}
        else:
            s2 = {"scene2_value": round(n2 / warm2, 2),
                  "scene2_vs_baseline": round((n2 / warm2)
                                              / (n2 / ref2_dt), 3)}
    except Exception as e:  # scene 2 must not void the primary metric
        print(f"scene2 failed: {e!r}", file=sys.stderr)
        s2 = {"scene2_error": str(e)[:120]}

    from pindel_tpu.profiling import g_fallback
    value = n_reads / warm_dt
    baseline = n_reads / ref_dt
    print(json.dumps({"metric": "split-reads/s/chip",
                      "value": round(value, 2),
                      "unit": "reads/s",
                      "vs_baseline": round(value / baseline, 3),
                      "fallback_ratio": round(g_fallback.ratio(), 5),
                      **s2}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
