"""Multi-device sharded search: data-parallel reads × window-parallel lanes.

The reference scales with OpenMP threads over reads (read_buffer.cpp:39,
pindel.cpp:1118); this design shards over a 2-D ``jax.sharding.Mesh``:

* ``dp`` (data parallel): the read batch axis — no cross-talk;
* ``wp`` (window parallel): candidate window columns — the per-length
  uniqueness decision needs *global* candidate statistics, reconstructed
  with ``psum``/``pmin`` collectives over ``wp`` (the reference's
  sequential scan over PD[] position lists has no equivalent; this is the
  reduction structure of SURVEY.md §2.3).

Semantics match ops/engine_jax.py (and therefore the NumPy oracle and the
reference recursion) exactly; tests compare all three.
"""
from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from pindel_tpu import dna
from pindel_tpu.config import MAX_READ_LENGTH

DEAD = 127  # plain int: avoid backend init at import time


def make_mesh(n_devices: int, dp: int = None) -> Mesh:
    """2-D mesh over the first n_devices: (dp, wp)."""
    devs = np.array(jax.devices()[:n_devices])
    if dp is None:
        dp = 2 if n_devices % 2 == 0 else 1
    wp = n_devices // dp
    return Mesh(devs.reshape(dp, wp), ("dp", "wp"))


def _search_step_local(chrom, slice_start, reverse, qq, valid_w, qlen,
                       max_snp, tsec_minus, maxmm, max_allowed,
                       *, w_total: int, w_local: int, lmax: int, nl: int,
                       mpm: int, bp_start: int):
    """Per-shard body run under shard_map; collectives over 'wp'.

    Shapes (local): slice_start/reverse/valid_w [B_l, NL]; qq [B_l, NL, L].
    Each wp shard owns window columns [off, off + w_local) of every lane.
    """
    tile_len = w_local + lmax
    wp_idx = jax.lax.axis_index("wp")
    off = wp_idx * w_local

    def load_tile(start, rev):
        # forward tiles advance with the shard offset; reversed (backward)
        # tiles advance from the other end so candidate w_global stays
        # consistent with the unsharded kernel's tile-index convention.
        fstart = start + off
        rstart = start + (w_total - w_local) - off
        t = jax.lax.dynamic_slice(
            chrom, (jnp.where(rev, rstart, fstart),), (tile_len,))
        return jax.lax.select(rev, jnp.flip(t), t)

    tiles = jax.vmap(jax.vmap(load_tile))(slice_start, reverse)

    widx = jnp.arange(w_local, dtype=jnp.int32) + off        # global col ids
    wvalid = widx[None, None, :] < valid_w[:, :, None]
    seeded = (tiles[:, :, :w_local] == qq[:, :, 0:1]) & wvalid
    seeded &= (qq[:, :, 0:1] != dna.N)

    key_base = (jnp.arange(nl, dtype=jnp.int32)[None, :, None] * w_total
                + widx[None, None, :])                        # [1, NL, Wl]
    BIGKEY = jnp.int32(2 ** 30)

    def step(carry, l):
        cum, cum_at_end, strict_hist = carry
        ref = jax.lax.dynamic_slice_in_dim(tiles, l, w_local, axis=2)
        qb = jax.lax.dynamic_slice_in_dim(qq, l, 1, axis=2)
        is_n = qb == dna.N
        match = jnp.where(is_n, ref != dna.N, ref == qb)
        strict_mm = (ref != qb).astype(jnp.int8)
        first = l == 0
        mm_step = jnp.where(first, 0, (~match).astype(jnp.int32))
        cum = cum + mm_step
        cum_at_end = jnp.where(l == qlen[:, None, None] - 1, cum, cum_at_end)
        strict_hist = jnp.where(
            first,
            strict_hist.at[..., :].set(0),
            strict_hist.at[..., l % mpm].set(strict_mm))
        strict_bad = strict_hist.sum(axis=-1) > 0

        lvl = jnp.where(seeded & (cum <= tsec_minus[:, None, None]),
                        cum, DEAD)
        lvl_cap = jnp.where(lvl <= max_snp[:, None, None], lvl, DEAD)
        min_local = jnp.min(lvl_cap, axis=(1, 2))
        min_mm = jax.lax.pmin(min_local, "wp")                # global min
        at_min = lvl == min_mm[:, None, None]
        cnt1 = jax.lax.psum(
            jnp.sum(at_min, axis=(1, 2), dtype=jnp.int32), "wp")
        hi = jnp.minimum(min_mm + (tsec_minus - max_snp), tsec_minus)
        cntp = jax.lax.psum(
            jnp.sum(lvl <= hi[:, None, None], axis=(1, 2), dtype=jnp.int32),
            "wp")
        # representative = smallest (lane-major, global column) key at min
        keys = jnp.where(at_min, key_base, BIGKEY)
        key_local = jnp.min(keys, axis=(1, 2))
        key_glob = jax.lax.pmin(key_local, "wp")              # [B_l]
        sel = keys == key_glob[:, None, None]
        rep_strict_bad = jax.lax.psum(
            jnp.sum(sel & strict_bad, axis=(1, 2), dtype=jnp.int32),
            "wp") > 0
        rep_cum = jax.lax.psum(
            jnp.sum(jnp.where(sel, cum, 0), axis=(1, 2), dtype=jnp.int32),
            "wp")
        return (cum, cum_at_end, strict_hist), (min_mm, cnt1, cntp,
                                                key_glob, rep_strict_bad,
                                                rep_cum)

    cum0 = jnp.zeros(seeded.shape, dtype=jnp.int32)
    hist0 = jnp.zeros(seeded.shape + (mpm,), dtype=jnp.int8)
    (_, cum_final, _), outs = jax.lax.scan(
        step, (cum0, cum0, hist0), jnp.arange(lmax, dtype=jnp.int32))
    min_mm, cnt1, cntp, key_glob, rep_strict_bad, _rep_cum = [
        jnp.moveaxis(o, 0, 1) for o in outs]                  # [B_l, Lmax]

    # whole-read mismatch of the representative candidate
    keys_full = jnp.broadcast_to(key_base, cum_final.shape)
    sel_full = keys_full[:, None, :, :] == key_glob[:, :, None, None]
    full_mm = jax.lax.psum(
        jnp.sum(jnp.where(sel_full, cum_final[:, None, :, :], 0),
                axis=(2, 3), dtype=jnp.int32), "wp")          # [B_l, Lmax]

    lens = jnp.arange(1, lmax + 1, dtype=jnp.int32)[None, :]
    in_range = (lens >= bp_start) & (lens <= qlen[:, None] - 1)
    maxmm_l = maxmm[jnp.minimum(lens, MAX_READ_LENGTH - 1)]
    stop_here = in_range & (min_mm > maxmm_l)
    alive = jnp.cumsum(stop_here.astype(jnp.int32), axis=1) == 0

    rep_lane = key_glob // w_total
    rep_w = key_glob % w_total
    rep_reverse = jnp.take_along_axis(reverse, rep_lane, axis=1)
    len_ok = jnp.where(rep_reverse, lens >= mpm, lens > mpm)
    whole_read_bad_fit = full_mm.astype(jnp.float32) >= max_allowed[:, None]

    emit = (in_range & alive
            & (min_mm <= max_snp[:, None])
            & (cnt1 == 1)
            & (lens >= bp_start + min_mm)
            & (cntp == 1)
            & (min_mm <= maxmm_l)
            & len_ok
            & ~rep_strict_bad
            & whole_read_bad_fit)
    return emit, min_mm, rep_lane, rep_w, full_mm


def build_sharded_search(mesh: Mesh, *, w_total: int, lmax: int, nl: int,
                         mpm: int, bp_start: int):
    """jit a dp×wp-sharded search step over ``mesh``.

    Returns fn(chrom, slice_start, reverse, qq, valid_w, qlen, max_snp,
    tsec_minus, maxmm, max_allowed) with batch sharded on 'dp', the
    candidate window sharded on 'wp', and the chromosome replicated.
    """
    wp = mesh.shape["wp"]
    assert w_total % wp == 0, (w_total, wp)
    w_local = w_total // wp

    body = functools.partial(_search_step_local, w_total=w_total,
                             w_local=w_local, lmax=lmax, nl=nl, mpm=mpm,
                             bp_start=bp_start)
    in_specs = (P(), P("dp", None), P("dp", None), P("dp", None, None),
                P("dp", None), P("dp"), P("dp"), P("dp"), P(), P("dp"))
    out_specs = (P("dp", None),) * 5
    sm = shard_map(body, mesh=mesh, in_specs=in_specs,
                   out_specs=out_specs, check_vma=False)
    return jax.jit(sm)


class ShardedJaxBackend:
    """Searcher backend running on a device mesh (see ops/engine_jax.py
    for the lane/bucket plumbing, identical here)."""

    def __init__(self, settings, maxmm: np.ndarray, chrom_codes: np.ndarray,
                 mesh: Mesh,
                 w_buckets: Tuple[int, ...] = (128, 512, 2048, 8192, 32768)):
        self.mpm = settings.min_perfect_match_around_bp
        self.rate = settings.max_allowed_mismatch_rate
        self.maxmm = np.asarray(maxmm, dtype=np.int32)
        self.chrom = np.asarray(chrom_codes)
        self.mesh = mesh
        self.dp = mesh.shape["dp"]
        self.wp = mesh.shape["wp"]
        self.w_buckets = tuple(sorted(w_buckets))
        self._compiled = {}

    def _bucket(self, width: int) -> int:
        for b in self.w_buckets:
            if width <= b:
                return (b + self.wp - 1) // self.wp * self.wp
        m = self.wp * 1024
        return (width + m - 1) // m * m

    def run(self, batch_lanes, bp_start, max_snps, tsec_minus):
        from pindel_tpu.genome import SPACER
        if not batch_lanes:
            return []
        nl = max(len(lanes) for lanes in batch_lanes)
        widths = [max((ln.end - ln.start) for ln in lanes) if lanes else 1
                  for lanes in batch_lanes]
        w = self._bucket(max(max(widths), 1))
        qlens = [int(lanes[0].query.shape[0]) for lanes in batch_lanes]
        lmax = (max(qlens) + 31) // 32 * 32
        assert w + lmax <= SPACER

        b = len(batch_lanes)
        b_pad = (b + self.dp - 1) // self.dp * self.dp
        slice_start = np.zeros((b_pad, nl), dtype=np.int32)
        rev = np.zeros((b_pad, nl), dtype=bool)
        qq = np.full((b_pad, nl, lmax), dna.N, dtype=np.int8)
        valid_w = np.zeros((b_pad, nl), dtype=np.int32)
        lane_dir_minus = np.zeros((b_pad, nl), dtype=bool)
        lane_strand_minus = np.zeros((b_pad, nl), dtype=bool)
        lane_fwd = np.ones((b_pad, nl), dtype=bool)
        lane_chr = [[""] * nl for _ in range(b_pad)]
        for i, lanes in enumerate(batch_lanes):
            for j, lane in enumerate(lanes):
                lw = max(lane.end - lane.start, 0)
                n = lane.query.shape[0]
                if lane.forward:
                    slice_start[i, j] = lane.start
                    qq[i, j, :n] = lane.query
                else:
                    slice_start[i, j] = lane.end - w - lmax
                    rev[i, j] = True
                    qq[i, j, :n] = lane.query[::-1]
                    lane_fwd[i, j] = False
                valid_w[i, j] = min(lw, w)
                lane_dir_minus[i, j] = lane.direction == "-"
                lane_strand_minus[i, j] = lane.strand == "-"
                lane_chr[i][j] = lane.chr_name

        qlen_a = np.zeros(b_pad, dtype=np.int32)
        qlen_a[:b] = qlens
        ms = np.zeros(b_pad, dtype=np.int32)
        ms[:b] = max_snps
        tm = np.zeros(b_pad, dtype=np.int32)
        tm[:b] = tsec_minus
        max_allowed = np.zeros(b_pad, dtype=np.float32)
        max_allowed[:b] = np.float32(
            np.array(qlens, dtype=np.float64) * np.float64(self.rate))

        key = (w, lmax, nl, bp_start)
        if key not in self._compiled:
            self._compiled[key] = build_sharded_search(
                self.mesh, w_total=w, lmax=lmax, nl=nl, mpm=self.mpm,
                bp_start=bp_start)
        fn = self._compiled[key]
        emit, min_mm, rep_lane, rep_w, full_mm = jax.device_get(fn(
            jnp.asarray(self.chrom), jnp.asarray(slice_start),
            jnp.asarray(rev), jnp.asarray(qq), jnp.asarray(valid_w),
            jnp.asarray(qlen_a), jnp.asarray(ms), jnp.asarray(tm),
            jnp.asarray(self.maxmm), jnp.asarray(max_allowed)))

        from pindel_tpu.ops.engine_jax import decode_emissions
        emit = np.asarray(emit)[:b]
        full_mm = np.asarray(full_mm)[:b]
        last = np.where(emit.any(axis=1),
                        emit.shape[1] - 1 - np.argmax(emit[:, ::-1], axis=1),
                        0)
        full_last = full_mm[np.arange(b), last]
        return decode_emissions(
            emit, np.asarray(min_mm)[:b],
            np.asarray(rep_lane)[:b], np.asarray(rep_w)[:b],
            full_last, slice_start[:b], w, lmax,
            lane_fwd[:b], lane_dir_minus[:b], lane_strand_minus[:b],
            lane_chr[:b])
