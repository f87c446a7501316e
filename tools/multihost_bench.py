#!/usr/bin/env python
"""Multi-host scaling measurement: --hosts N vs single-process.

BASELINE.md's efficiency bar is >80% scaling efficiency at 2 hosts.
This tool times the same scene single-process and windows-sharded over
N processes (fused backend on the CPU: --hosts runs one JAX process per
host, and several processes cannot share one GPU), asserts the reports
are byte-identical, and prints one JSON line:

  {"t1": ..., "tN": ..., "hosts": N, "speedup": ..., "efficiency": ...}

Run:

  python tools/multihost_bench.py [--hosts 2] [--events 60]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tools"))

os.environ["JAX_PLATFORMS"] = "cpu"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--hosts", type=int, default=2)
    ap.add_argument("--events", type=int, default=60)
    ap.add_argument("--chrom-len", type=int, default=1_200_000)
    ap.add_argument("--noise", type=int, default=3000)
    ap.add_argument("--dist", choices=["files", "jax"], default="files")
    ap.add_argument("--bam", action="store_true",
                    help="BAM input + BreakDancer evidence scene (the "
                         "sharded RP->BD chain under --hosts)")
    args = ap.parse_args()

    from make_fai import make_fai

    from pindel_tpu.testing.simulate import standard_scene, write_fasta
    d = tempfile.mkdtemp(prefix="pindel_mh_bench_")
    kinds = ["DEL", "SI", "DI", "INV", "TD", "LI"] * (args.events // 6)
    ref, events, reads = standard_scene(
        seed=99, chrom_len=args.chrom_len, kinds=kinds,
        reads_per_event=10, n_noise=args.noise, chrom="chrM")
    fa = os.path.join(d, "ref.fa")
    write_fasta(fa, [("chrM", ref)])
    make_fai(fa)
    txt = os.path.join(d, "reads.txt")
    reads.write(txt)
    n_reads = len(reads.names)
    print(f"scene: {n_reads} reads over {args.chrom_len//1000} kb, "
          f"window 100 kb", file=sys.stderr)

    from pindel_tpu.__main__ import main as cli
    if args.bam:
        # convert the text scene to a paired BAM + a BD file naming
        # each event, so every rank runs the full RP->BD evidence chain
        from pindel_tpu.testing.bamwriter import split_read_pairs, write_bam
        bam = os.path.join(d, "reads.bam")
        write_bam(bam, [("chrM", len(ref))], split_read_pairs(reads, ref))
        cfg = os.path.join(d, "bam.cfg")
        with open(cfg, "w") as fh:
            fh.write(f"{bam}\t500\tS1\n")
        bd = os.path.join(d, "bd.txt")
        with open(bd, "w") as fh:
            fh.write("#chr1\tpos1\tori1\tchr2\tpos2\tori2\ttype\tsize"
                     "\tscore\n")
            for ev in events:
                if ev.kind in ("DEL", "DI", "INV", "TD"):
                    fh.write(f"chrM\t{ev.pos}\t20+20-\tchrM\t"
                             f"{ev.pos + ev.size}\t18+19-\t{ev.kind}\t"
                             f"{ev.size}\t99\n")
        base = ["-f", fa, "-i", cfg, "-b", bd, "-w", "0.1", "-s",
                "--backend", "fused"]
    else:
        base = ["-f", fa, "-p", txt, "-w", "0.1", "-l", "-s",
                "--backend", "fused"]

    # a simulated "host" = one disjoint CPU share: the single-process
    # baseline runs on one share, each of the N processes on its own (one
    # XLA-CPU process would otherwise saturate the whole machine and mask
    # the sharding)
    all_cpus = sorted(os.sched_getaffinity(0))
    per = max(len(all_cpus) // args.hosts, 1)
    os.sched_setaffinity(0, all_cpus[:per])
    print(f"host share: {per} of {len(all_cpus)} cpus", file=sys.stderr)

    t0 = time.time()
    assert cli([*base, "-o", os.path.join(d, "single")]) == 0
    t1 = time.time() - t0
    print(f"single: {t1:.2f}s", file=sys.stderr)

    os.sched_setaffinity(0, all_cpus)
    os.environ["PINDEL_TPU_CPU_SHARD"] = "1"
    t0 = time.time()
    assert cli([*base, "-o", os.path.join(d, "multi"),
                "--hosts", str(args.hosts), "--dist", args.dist]) == 0
    tn = time.time() - t0
    os.sched_setaffinity(0, all_cpus)
    print(f"hosts={args.hosts}: {tn:.2f}s", file=sys.stderr)

    sufs = ("D", "SI", "TD", "INV", "CloseEndMapped", "RP") if args.bam \
        else ("D", "SI", "TD", "INV", "LI", "CloseEndMapped")
    for suf in sufs:
        single = open(os.path.join(d, f"single_{suf}")).read()
        multi = open(os.path.join(d, f"multi_{suf}")).read()
        if single != multi:
            print(json.dumps({"error": f"_{suf} differs"}))
            return 1

    speedup = t1 / tn
    result = {"t1": round(t1, 2), "tN": round(tn, 2),
              "hosts": args.hosts,
              "reads": n_reads,
              "dist": args.dist,
              "scene": "bam+bd" if args.bam else "text",
              "physical_cpus": len(os.sched_getaffinity(0)),
              "speedup": round(speedup, 3),
              "efficiency": round(speedup / args.hosts, 3)}
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
