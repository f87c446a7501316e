#!/usr/bin/env python
"""Smoke run of the split-read search on NVIDIA GPUs.

    python chip_smoke.py           # one card: every phase below
    python chip_smoke.py --four    # four cards: the full-size scene with
                                   # --backend mesh against one-card fused

Phases (one card), each printing its seconds:

1. device  - requires a GPU; prints the card's name and power limit, the
             JAX version, the compile-cache directory and the device kind;
2. kernels - the scan kernel on the card bit-equal to the XLA twin on the
             CPU at 65,536 rows for every window bucket up to 2048 and
             read lengths up to 128 and 256; the three jitted search
             kernels on the card bit-equal to the same functions on the
             CPU; the time of the kernel and of the twin on the card;
3. oracle  - ``python -m pindel_tpu`` (through ``main``, with -l -k -s)
             on the card against ``--backend numpy``, byte-identical
             reports, on a 4,000-read text scene and on a BAM +
             BreakDancer scene;
4. full    - a 15 Mb, ~145k-read scene, cold and warm: wall time,
             reads/s, the fused path's fallback ratio (at most 1%) and
             peak device memory; warm reports equal cold ones.

Any failure exits non-zero.  Without a GPU it exits non-zero before any
result.  The last line of stdout is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

SEED = 2024
SCAN_ROWS = 65_536                     # CHUNK 32,768 reads x 2 lanes
W_BUCKETS = (128, 192, 256, 384, 512, 768, 1024, 1536, 2048)
LMAX_STEPS = ((128, 112), (256, 160))  # 100 bp and 150 bp reads
CPU_ROWS = 4096                        # twin rows per CPU thread
KERNEL_B = 2048
CLOSE_SHAPE = dict(w0=512, w1=1536, lmax=128, mpm=3, bp_start=8,
                   lsteps=112, with_r1=True)
FAR_SHAPE = dict(spans=(64, 256, 1024), ws=(128, 512, 2048), lmax=128,
                 mpm=3, bp_start=10, lsteps=112)
FAR_WIN_SHAPE = dict(w=2048, lmax=128, mpm=3, bp_start=10, lsteps=112)
TIME_SHAPE = (32_768, 1536, 128, 112)  # close range 1: rows, w, lmax, lsteps
REPORTS = ("D", "SI", "TD", "INV", "LI", "BP", "CloseEndMapped")
FULL_KINDS = ["DEL", "SI", "DI", "INV", "TD"] * 150
MAX_FALLBACK = 0.01


def say(msg: str) -> None:
    print(msg, flush=True)


class Phase:
    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        say(f"== {self.name}")
        self.t0 = time.monotonic()

    def __exit__(self, *exc):
        if exc[0] is None:
            say(f"phase {self.name}: {time.monotonic() - self.t0:.3f} s")


# ------------------------------------------------------------------ device
def phase_device(n_cards: int):
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        sys.exit(f"chip_smoke: needs a GPU; JAX found {devs[0].platform}")
    if len(devs) < n_cards:
        sys.exit(f"chip_smoke: needs {n_cards} GPUs; JAX found {len(devs)}")
    from pindel_tpu.compile_cache import enable_compile_cache
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.splitlines()[0]
    say(card)
    say(f"jax {jax.__version__}; compile cache {enable_compile_cache()}")
    say(f"device {devs[0].device_kind} x{len(devs)}")
    return devs[:n_cards], card


# ----------------------------------------------------------------- kernels
def scan_inputs(rng, rows: int, w: int, lmax: int, lsteps: int):
    """Rows of the engine's tile layout: a 128-aligned chromosome slice
    per row with an unaligned window start ``off``, and a query copied
    from the window with ~2% substitutions and some N bases."""
    from pindel_tpu import dna
    t = ((w + lmax + 127) // 128 + 1) * 128
    tiles = rng.integers(0, 4, (rows, t), dtype=np.int8)
    tiles[rng.random((rows, t)) < 0.005] = dna.N
    off = rng.integers(0, 128, rows).astype(np.int32)
    qlen = rng.integers(lsteps // 2, lsteps + 1, rows).astype(np.int32)
    start = off + rng.integers(0, w, rows)
    li = np.arange(lmax)[None, :]
    src = np.take_along_axis(tiles, np.minimum(start[:, None] + li, t - 1),
                             axis=1)
    sub = rng.random((rows, lmax)) < 0.02
    qq = np.where(sub, (src + 1) % 4, src)
    qq = np.where(li < qlen[:, None], qq, dna.N).astype(np.int8)
    valid_w = rng.integers(1, w + 1, rows).astype(np.int32)
    thr = rng.integers(1, 8, rows).astype(np.int32)
    return tiles, qq, valid_w, qlen, thr, off


def on(dev, arrays):
    import jax
    return [jax.device_put(a, dev) for a in arrays]


def check_scan(scan, gpu, cpu, pool, rng, rows, w, lmax, lsteps):
    """The scan on the card against the XLA twin on the CPU device (the
    same jitted function: it lowers the twin for a CPU device)."""
    args = scan_inputs(rng, rows, w, lmax, lsteps)
    static = dict(w=w, lmax=lmax, mpm=3, lsteps=lsteps)
    got = [np.asarray(x) for x in scan(*on(gpu, args), **static)]

    def twin(lo):
        part = [a[lo:lo + CPU_ROWS] for a in args]
        return [np.asarray(x) for x in scan(*on(cpu, part), **static)]

    parts = list(pool.map(twin, range(0, rows, CPU_ROWS)))
    for k, name in enumerate(("kmin", "k2")):
        want = np.concatenate([p[k] for p in parts])
        if not np.array_equal(got[k], want):
            bad = np.argwhere(got[k] != want)
            raise AssertionError(
                f"scan {name} differs at rows={rows} w={w} lmax={lmax}: "
                f"{len(bad)} entries, first {bad[0].tolist()}")
    say(f"scan rows={rows} w={w} lmax={lmax} lsteps={lsteps}: bit-equal")


def median_time(fn, n: int = 5) -> float:
    import jax
    jax.block_until_ready(fn())
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


def kernel_inputs(rng, b: int):
    """A chromosome and payloads for the close, far and explicit-window
    kernels whose reads are split between two chromosome slices near
    their anchors, so chains emit."""
    from pindel_tpu.genome import SPACER
    from pindel_tpu.ops import engine_fused as ef
    core = 2_000_000
    chrom = rng.integers(0, 4, core + 2 * SPACER, dtype=np.int8)
    lmax, qlen = 128, np.full(b, 100, np.int32)
    anchor = rng.integers(10_000, core - 10_000, b)
    isz = np.full(b, 500, np.int64)
    minus = rng.random(b) < 0.5
    cut = rng.integers(30, 71, b)
    near = SPACER + anchor + rng.integers(-1400, 1400, b)
    far = SPACER + anchor + rng.integers(-900, 900, b)
    li = np.arange(lmax)[None, :]
    src = np.where(li < cut[:, None], near[:, None] + li,
                   far[:, None] + li)
    codes = np.where(li < qlen[:, None], chrom[src], 4).astype(np.int8)
    flip = rng.random(b) < 0.5                  # half the reads as RC
    codes[flip, :100] = 3 - codes[flip, 99::-1]
    ms = np.full(b, 5, np.int32)
    tm, thr = ms + 1, np.full(b, 2, np.int32)
    rev = ef._reverse_codes_np(codes, qlen)
    close = ef._pack_payload(
        np.concatenate([codes, rev], axis=1),
        ef._close_meta(anchor.astype(np.int64), isz, qlen, ms, tm, thr,
                       minus))
    far_p = ef._pack_payload(codes, ef._far_meta(
        SPACER + anchor, qlen, np.full(b, 40, np.int32),
        np.zeros(b, np.int32), ms, tm, thr, chrom.shape[0]))
    win = np.zeros((b, ef.FW_WORDS), np.int32)
    win[:, 0] = SPACER + anchor - 1000
    win[:, 1] = SPACER + anchor + 1000
    win[:, 2] = qlen
    win[:, 3] = ms | (tm << 8) | (thr << 16)
    far_win = ef._pack_payload(codes, win)
    return chrom, close, far_p, far_win


def phase_kernels(gpu, card: str) -> None:
    import jax
    from pindel_tpu.config import Settings
    from pindel_tpu.ops import engine_fused as ef
    cpu = jax.devices("cpu")[0]
    rng = np.random.default_rng(SEED)
    scan = jax.jit(ef._scan_rows, static_argnames=("w", "lmax", "mpm",
                                                   "lsteps"))
    threads = max((os.cpu_count() or 2) - 2, 1)
    with ThreadPoolExecutor(threads) as pool:
        for lmax, lsteps in LMAX_STEPS:
            for w in W_BUCKETS:
                check_scan(scan, gpu, cpu, pool, rng, SCAN_ROWS, w, lmax,
                           lsteps)
        # a row count that is no multiple of the kernel's row block
        check_scan(scan, gpu, cpu, pool, rng, SCAN_ROWS - 5, 1536, 128, 112)
        check_scan(scan, gpu, cpu, pool, rng, SCAN_ROWS - 5, 192, 256, 160)

    # the three jitted search kernels, card against CPU
    chrom, close, far_p, far_win = kernel_inputs(rng, KERNEL_B)
    maxmm = np.asarray(Settings().max_mismatch(), np.int32)
    for name, fn, payload, static in (
            ("close", ef._close_kernel_jit, close, CLOSE_SHAPE),
            ("far", ef._far_kernel_jit, far_p, FAR_SHAPE),
            ("far_win", ef._far_win_kernel_jit, far_win, FAR_WIN_SHAPE)):
        outs = []
        for dev in (gpu, cpu):
            cat = ef._chrom_cat(jax.device_put(chrom, dev))
            outs.append(np.asarray(fn(cat, *on(dev, (payload, maxmm)),
                                      **static)))
        if not np.array_equal(outs[0], outs[1]):
            raise AssertionError(f"{name} kernel: card differs from CPU")
        nw = static["lmax"] // 32
        emitting = int((outs[0][:, :nw] != 0).any(axis=1).sum())
        say(f"{name} kernel b={KERNEL_B}: bit-equal, {emitting} reads emit")

    # both scan implementations on the card at the close range-1 shape
    rows, w, lmax, lsteps = TIME_SHAPE
    args = on(gpu, scan_inputs(rng, rows, w, lmax, lsteps))
    static = dict(w=w, lmax=lmax, mpm=3, lsteps=lsteps)
    twin = jax.jit(ef._xla_scan_rows, static_argnames=tuple(static))
    t_kernel = median_time(lambda: scan(*args, **static))
    t_twin = median_time(lambda: twin(*args, **static))
    say(f"scan time rows={rows} w={w} lmax={lmax} lsteps={lsteps} on "
        f"{card}: kernel {t_kernel * 1e3:.3f} ms, XLA twin "
        f"{t_twin * 1e3:.3f} ms")


# ------------------------------------------------------------------ oracle
def run_cli(argv) -> float:
    from pindel_tpu.__main__ import main
    t0 = time.monotonic()
    if main(argv) != 0:
        raise AssertionError(f"main({argv}) failed")
    return time.monotonic() - t0


def same_reports(a: str, b: str, suffixes) -> None:
    for suf in suffixes:
        with open(f"{a}_{suf}") as fa, open(f"{b}_{suf}") as fb:
            if fa.read() != fb.read():
                raise AssertionError(f"_{suf} differs: {a} vs {b}")


def text_scene(d: str, name: str, **kw):
    from pindel_tpu.testing.simulate import standard_scene, write_fasta
    ref, _events, reads = standard_scene(seed=SEED, chrom=name, **kw)
    fa = os.path.join(d, f"{name}.fa")
    write_fasta(fa, [(name, ref)])
    txt = os.path.join(d, f"{name}.txt")
    reads.write(txt)
    return fa, txt, len(reads.names)


def phase_oracle(d: str) -> None:
    from pindel_tpu.testing.scenes import bam_breakdancer_scene
    fa, txt, n = text_scene(
        d, "chrO", chrom_len=1_000_000,
        kinds=["DEL", "SI", "DI", "INV", "TD", "LI"] * 10,
        reads_per_event=30, n_noise=2_200)
    base = ["-f", fa, "-p", txt, "-l", "-k", "-s"]
    t_card = run_cli([*base, "-o", f"{d}/card", "--backend", "fused"])
    t_np = run_cli([*base, "-o", f"{d}/oracle", "--backend", "numpy"])
    same_reports(f"{d}/card", f"{d}/oracle", REPORTS)
    with open(f"{d}/oracle_D") as fh:
        n_del = fh.read().count("ChrID")
    say(f"text scene {n} reads over 1 Mb: reports byte-identical "
        f"({n_del} deletions; card {t_card:.3f} s, numpy {t_np:.3f} s)")

    fa, cfg, bd = bam_breakdancer_scene(d)
    base = ["-f", fa, "-i", cfg, "-b", bd, "-l", "-k", "-s"]
    run_cli([*base, "-o", f"{d}/bdcard", "--backend", "fused"])
    run_cli([*base, "-o", f"{d}/bdoracle", "--backend", "numpy"])
    same_reports(f"{d}/bdcard", f"{d}/bdoracle", REPORTS + ("RP",))
    with open(f"{d}/bdoracle_D") as fh:
        if "D 9000" not in fh.read():
            raise AssertionError("BD-window deletion not called")
    say("BAM + BreakDancer scene: reports byte-identical, BD deletion "
        "called")


# -------------------------------------------------------------- full size
def full_scene(d: str):
    return text_scene(d, "chrF", chrom_len=15_000_000, kinds=FULL_KINDS,
                      reads_per_event=60, n_noise=100_000)


def peak_bytes(devs) -> int:
    return max(dv.memory_stats()["peak_bytes_in_use"] for dv in devs)


def timed_run(fa, txt, n, prefix, backend, label, devs) -> None:
    import jax
    from pindel_tpu.profiling import g_fallback
    g_fallback.reset()
    wall = run_cli(["-f", fa, "-p", txt, "-o", prefix, "-T", "4", "-l",
                    "-k", "-s", "--backend", backend])
    ratio = g_fallback.ratio()
    peak = peak_bytes(devs)
    say(f"{label}: {wall:.3f} s, {n / wall:.1f} reads/s, fallback "
        f"{g_fallback.fallback}/{g_fallback.total} = {ratio:.6f}, peak "
        f"device memory {peak} B")
    if ratio > MAX_FALLBACK:
        raise AssertionError(f"fallback ratio {ratio} > {MAX_FALLBACK}")


def phase_full(d: str, devs) -> None:
    fa, txt, n = full_scene(d)
    say(f"full-size scene: {n} reads over 15 Mb")
    timed_run(fa, txt, n, f"{d}/cold", "fused", "fused cold", devs)
    timed_run(fa, txt, n, f"{d}/warm", "fused", "fused warm", devs)
    same_reports(f"{d}/warm", f"{d}/cold", REPORTS)
    say("warm reports equal cold reports")


def phase_four(d: str, devs) -> None:
    fa, txt, n = full_scene(d)
    say(f"full-size scene: {n} reads over 15 Mb")
    timed_run(fa, txt, n, f"{d}/fused", "fused", "fused, 1 card", devs[:1])
    timed_run(fa, txt, n, f"{d}/mesh", "mesh", "mesh cold, 4 cards", devs)
    timed_run(fa, txt, n, f"{d}/mesh", "mesh", "mesh warm, 4 cards", devs)
    same_reports(f"{d}/mesh", f"{d}/fused", REPORTS)
    say("--backend mesh on 4 cards: reports byte-identical to fused")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="full-size scene on four cards (--backend mesh) "
                         "against one-card fused, and nothing else")
    args = ap.parse_args()
    n_cards = 4 if args.four else 1
    with Phase("device"):
        devs, card = phase_device(n_cards)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as d:
        if args.four:
            with Phase("four"):
                phase_four(d, devs)
        else:
            with Phase("kernels"):
                phase_kernels(devs[0], card)
            with Phase("oracle"):
                phase_oracle(d)
            with Phase("full"):
                phase_full(d, devs)
    say(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
