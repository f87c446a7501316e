"""Hopper kernel for the pattern-growth length scan (Pallas, Triton route).

Computes exactly what ``engine_fused._xla_scan_rows`` computes — per row,
per length step, the min packed key over the window and the min over the
remaining keys (see that function for the key layout and the two-pass
structure: whole-read totals for the fit bit, then the scan proper).

The XLA form carries two ``[rows, WE]`` int32 arrays through device
memory on every one of ~112 length steps.  Here one block owns BR rows x
WT window lanes and keeps both carries in registers for the whole scan:
it reads its int8 tile slice at offset ``l`` on each step (the slice
stays in L1) and writes one (kmin, k2) pair per row and step.

Blocks run in parallel with no carried state.  The grid is (row blocks,
window tiles); each tile writes its own per-length pair, merged after
the call by the associative rule

    K = min_t kmin_t,    k2 = min_t (kmin_t == K ? k2_t : kmin_t)

which is the min over all keys != K: a tile whose kmin exceeds K holds
no key equal to K, so its smallest key is its kmin.  That includes dead
lanes whose clamped window offsets collide with live ones.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from pindel_tpu import dna

# block shape and launch settings: the fastest of a sweep on an H100
# (PERF.md); WE is always a multiple of 128
BR = 16              # rows per block
WT = 128             # window lanes per block
NUM_WARPS = 4
NUM_STAGES = 1
NEVER = -(1 << 20)   # lastmm sentinel: no strict mismatch yet
MAXI = 2 ** 31 - 1   # runner-up placeholder for the min-key lanes


def _kernel(tiles_ref, qq_ref, vw_ref, qlen_ref, thr_ref, off_ref,
            kmin_ref, k2_ref, *, w: int, mpm: int, shift: int,
            dead: int, lsteps: int):
    j0 = pl.program_id(1) * WT
    lanes = j0 + jnp.arange(WT, dtype=jnp.int32)[None, :]
    vw = vw_ref[...][:, None]
    qlen = qlen_ref[...][:, None]
    thr = thr_ref[...][:, None]
    off = off_ref[...][:, None]

    def ref_at(l):
        return tiles_ref[:, pl.ds(j0 + l, WT)].astype(jnp.int32)

    def q_at(l):
        return qq_ref[:, pl.ds(l, 1)].astype(jnp.int32)

    def mismatch(d, qb, l):
        # Matches() rule (q==N matches iff ref!=N), counted for steps
        # 1..qlen-1 only
        return (d ^ (qb == dna.N)) & ((l >= 1) & (l < qlen))

    # pass 1: whole-read mismatch totals -> per-candidate fit bit
    def total_body(l, tot):
        qb = q_at(l)
        return tot + mismatch(ref_at(l) != qb, qb, l).astype(jnp.int32)

    tot = jax.lax.fori_loop(0, lsteps, total_body,
                            jnp.zeros((BR, WT), jnp.int32))
    fitbad = (tot < thr).astype(jnp.int32)

    # pass 2: the scan proper
    q0 = q_at(0)
    seeded = ((ref_at(0) == q0) & (lanes >= off) & (lanes < off + vw)
              & (q0 != dna.N))
    woff = jnp.minimum(jnp.maximum(lanes - off, 0), w - 1)
    keybase0 = (jnp.where(seeded, 0, jnp.int32(dead)) << shift) \
        | (woff << 2) | fitbad

    def body(l, carry):
        keybase, lastmm = carry
        qb = q_at(l)
        d = ref_at(l) != qb
        keybase = keybase + (mismatch(d, qb, l).astype(jnp.int32) << shift)
        lastmm = jnp.where(d, jnp.where(l >= 1, l, jnp.int32(NEVER)),
                           lastmm)
        key = keybase + ((lastmm > l - mpm).astype(jnp.int32) << 1)
        kmin = jnp.min(key, axis=1)
        k2 = jnp.min(jnp.where(key == kmin[:, None], jnp.int32(MAXI), key),
                     axis=1)
        kmin_ref[pl.ds(l, 1), :] = kmin[None, :]
        k2_ref[pl.ds(l, 1), :] = k2[None, :]
        return keybase, lastmm

    jax.lax.fori_loop(0, lsteps, body,
                      (keybase0, jnp.full((BR, WT), NEVER, jnp.int32)))


def merge_tiles(kmin_t, k2_t):
    """[NT, ...] per-tile (kmin, k2) -> the whole-window pair."""
    k = jnp.min(kmin_t, axis=0)
    k2 = jnp.min(jnp.where(kmin_t == k[None], k2_t, kmin_t), axis=0)
    return k, k2


@functools.partial(jax.jit, static_argnames=("w", "lmax", "mpm", "lsteps",
                                             "interpret"))
def triton_scan_rows(tiles, qq, valid_w, qlen, thr, off,
                     *, w: int, lmax: int, mpm: int, lsteps: int,
                     interpret: bool = False):
    """Same contract as ``engine_fused._xla_scan_rows``: [R, T] int8 tiles
    -> (kmin, k2), [R, lmax] int32 packed keys with zeros past
    ``lsteps``."""
    from pindel_tpu.ops.engine_fused import I16DEAD, U8DEAD, _key_shift
    r, t = tiles.shape
    we = t - lmax
    assert we >= w and we % WT == 0, (t, w, lmax)
    shift = _key_shift(w)
    dead = U8DEAD if lmax <= 255 else I16DEAD
    assert ((dead + lmax) << shift) + (1 << shift) < 2 ** 31, (w, lmax)
    nt = we // WT

    rp = pl.cdiv(r, BR) * BR
    if rp != r:
        # padding rows: no seeds, sliced away below
        pad = rp - r
        tiles = jnp.pad(tiles, ((0, pad), (0, 0)))
        qq = jnp.pad(qq, ((0, pad), (0, 0)))
        valid_w = jnp.pad(valid_w, (0, pad))
        qlen = jnp.pad(qlen, (0, pad), constant_values=1)
        thr = jnp.pad(thr, (0, pad))
        off = jnp.pad(off, (0, pad))

    kern = functools.partial(_kernel, w=w, mpm=mpm, shift=shift,
                             dead=dead, lsteps=lsteps)
    row = pl.BlockSpec((BR,), lambda i, j: (i,))
    out = pl.BlockSpec((None, lsteps, BR), lambda i, j: (j, 0, i))
    kmin_t, k2_t = pl.pallas_call(
        kern,
        grid=(rp // BR, nt),
        in_specs=[pl.BlockSpec((BR, t), lambda i, j: (i, 0)),
                  pl.BlockSpec((BR, lmax), lambda i, j: (i, 0)),
                  row, row, row, row],
        out_specs=[out, out],
        out_shape=[jax.ShapeDtypeStruct((nt, lsteps, rp), jnp.int32)] * 2,
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=NUM_STAGES),
        backend="triton",
        interpret=interpret,
        name="pindel_scan",
    )(tiles, qq, valid_w.astype(jnp.int32), qlen.astype(jnp.int32),
      thr.astype(jnp.int32), off.astype(jnp.int32))
    kmin, k2 = merge_tiles(kmin_t, k2_t)
    pad = ((0, 0), (0, lmax - lsteps))
    return (jnp.pad(kmin.T[:r], pad), jnp.pad(k2.T[:r], pad))
