#!/usr/bin/env python
"""Microbenchmark the fused close/far kernels on the device.

Times a warm _close_kernel_jit / _far_kernel_jit launch at bench-scene
shapes (b=16384, w0=512, w1=1536, lmax=128, lsteps=112) so device cost
is separable from the pipeline's host glue.
"""
from __future__ import annotations

import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402


def main() -> int:
    import jax
    import jax.numpy as jnp

    from pindel_tpu.ops.engine_fused import (_chrom_cat, _close_kernel_jit,
                                             _close_meta, _far_kernel_jit,
                                             _far_meta, _pack_payload)
    from pindel_tpu.genome import SPACER

    rng = np.random.default_rng(0)
    chrom_len = 6_000_000 + 2 * SPACER
    chrom = _chrom_cat(jnp.asarray(rng.integers(0, 4, chrom_len,
                                                dtype=np.int8)))
    maxmm = jnp.asarray(np.minimum(np.arange(512) // 20 + 2, 30)
                        .astype(np.int32))

    b = int(sys.argv[1]) if len(sys.argv) > 1 else 16384
    dev = jax.devices()[0]
    print(f"device {dev.platform} {dev.device_kind}")
    lmax = 128
    qlen = np.full(b, 100, np.int32)
    # close payloads carry each read and its within-qlen reverse
    codes = rng.integers(0, 4, (b, 2 * lmax), dtype=np.int8)
    pos = rng.integers(10_000, 5_900_000, b).astype(np.int64)
    isz = np.full(b, 500, np.int64)
    ms = np.full(b, 5, np.int32)
    tm = ms + 1
    thr = np.full(b, 10, np.int32)
    minus = rng.integers(0, 2, b).astype(bool)

    meta = _close_meta(pos, isz, qlen, ms, tm, thr, minus)
    payload = jnp.asarray(_pack_payload(codes, meta))

    def timeit(fn, n=3):
        fn()  # compile
        ts = []
        for _ in range(n):
            t0 = time.monotonic()
            fn()
            ts.append(time.monotonic() - t0)
        return min(ts)

    kw = dict(w0=512, w1=1536, lmax=lmax, mpm=3, bp_start=8, lsteps=112)

    def close_full():
        out = _close_kernel_jit(chrom, payload, maxmm, with_r1=True, **kw)
        jax.block_until_ready(out)

    def close_r0():
        out = _close_kernel_jit(chrom, payload, maxmm, with_r1=False, **kw)
        jax.block_until_ready(out)

    t_full = timeit(close_full)
    t_r0 = timeit(close_r0)
    print(f"close b={b} both ranges: {t_full*1e3:.1f} ms "
          f"({b/t_full:.0f} rows/s)")
    print(f"close b={b} range0 only: {t_r0*1e3:.1f} ms  "
          f"(range1 cost ~{(t_full-t_r0)*1e3:.1f} ms)")

    center = rng.integers(200_000, 5_800_000, b).astype(np.int64)
    fmeta = _far_meta(center, qlen, np.full(b, 40, np.int32),
                      np.zeros(b, np.int32), ms, tm, thr, chrom_len)
    fpayload = jnp.asarray(_pack_payload(codes[:, :lmax], fmeta))

    def far():
        out = _far_kernel_jit(chrom, fpayload, maxmm,
                              spans=(64, 256, 1024), ws=(128, 512, 2048),
                              lmax=lmax, mpm=3, bp_start=10, lsteps=112)
        jax.block_until_ready(out)

    t_far = timeit(far)
    print(f"far   b={b} 3 rounds:    {t_far*1e3:.1f} ms "
          f"({b/t_far:.0f} rows/s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
