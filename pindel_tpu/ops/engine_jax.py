"""Batched JAX/XLA search engine (per-lane legacy path).

Reformulates the pattern-growth search (see ops/search_np.py for the rule
derivation and reference citations) as a length-scan over dense candidate
lanes:

* every lane (close end: one; far end: two per region — forward strand and
  the reverse-complement backward strand) is normalized to a *forward tile*:
  a contiguous chromosome slice, reversed for backward lanes, so the step
  compare is always ``tile[w + l] vs query[l]``;
* a ``lax.scan`` over prefix length carries per-candidate cumulative
  mismatch counts ([B, NL, W] int32 on the VPU) and per-step emits only the
  per-read aggregates the emission rules need (min level, uniqueness counts,
  representative index, strict-window bit) — O(B * Lmax) output;
* the unique-point emission decision (CheckLeft/Right_Close + CheckBoth +
  CheckMismatches logic) is evaluated vectorized on device; the host merely
  converts (read, length, candidate) winners into UniquePoint records.

Static shapes per launch: W (window, bucketed), Lmax (query pad), NL (max
lanes).  Reads are batched data-parallel; the same function shards over a
``jax.sharding.Mesh`` for multi-chip execution (see parallel/mesh.py).
"""
from __future__ import annotations

import dataclasses
import functools
import time
from typing import List, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from pindel_tpu import dna
from pindel_tpu.compile_cache import enable_compile_cache
from pindel_tpu.config import MAX_READ_LENGTH
from pindel_tpu.ops.search_np import Lane
from pindel_tpu.reads import AnchorSet

DEAD = 127      # dead-candidate mismatch level sentinel (plain int:
                # a jnp constant here would initialize the backend at
                # import time)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@functools.partial(
    jax.jit,
    static_argnames=("w", "lmax", "nl", "mpm", "bp_start"))
def _search_kernel(chrom, slice_start, reverse, qq, valid_w, qlen,
                   max_snp, tsec_minus, maxmm, max_allowed,
                   *, w: int, lmax: int, nl: int, mpm: int,
                   bp_start: int):
    """Device search over a batch.

    Args:
      chrom: [C] int8 padded chromosome codes.
      slice_start: [B, NL] int32 start of the contiguous tile slice.
      reverse: [B, NL] bool — tile is read right-to-left (backward lane).
      qq: [B, NL, Lmax] int8 oriented per-lane query codes.
      valid_w: [B, NL] int32 number of valid candidate offsets (<= W).
      qlen: [B] int32 query lengths.
      max_snp, tsec_minus: [B] int32 per-read budgets.
      maxmm: [MAX_READ_LENGTH] int32 budget table.
    Returns per (read, length-1): emit flag, level, rep lane, rep w, full_mm.
    """
    tile_len = w + lmax

    def load_tile(start, rev):
        t = jax.lax.dynamic_slice(chrom, (start,), (tile_len,))
        return jax.lax.select(rev, jnp.flip(t), t)

    tiles = jax.vmap(jax.vmap(load_tile))(slice_start, reverse)  # [B,NL,T]

    widx = jnp.arange(w, dtype=jnp.int32)                        # [W]
    wvalid = widx[None, None, :] < valid_w[:, :, None]           # [B,NL,W]
    seeded = (tiles[:, :, :w] == qq[:, :, 0:1]) & wvalid
    seeded &= (qq[:, :, 0:1] != dna.N)

    mpm_i = mpm

    def step(carry, l):
        cum, cum_at_end, strict_hist = carry
        # step l compares tile[w + l] vs qq[l]  (length L = l + 1 after seed)
        ref = jax.lax.dynamic_slice_in_dim(tiles, l, w, axis=2)   # [B,NL,W]
        qb = jax.lax.dynamic_slice_in_dim(qq, l, 1, axis=2)       # [B,NL,1]
        is_n = qb == dna.N
        match = jnp.where(is_n, ref != dna.N, ref == qb)
        strict_mm = (ref != qb).astype(jnp.int8)
        first = l == 0
        # seed step: cum stays 0 for seeded candidates
        mm_step = jnp.where(first, 0, (~match).astype(jnp.int32))
        cum = cum + mm_step
        # whole-read mismatch count snapshot at the final real step
        cum_at_end = jnp.where((l == qlen[:, None, None] - 1), cum, cum_at_end)
        strict_hist = jnp.where(
            first,
            strict_hist.at[..., :].set(0),
            strict_hist.at[..., l % mpm_i].set(strict_mm))
        strict_bad = strict_hist.sum(axis=-1) > 0                 # [B,NL,W]

        lvl = jnp.where(seeded & (cum <= tsec_minus[:, None, None]),
                        cum, DEAD)                                # [B,NL,W]
        lvl_cap = jnp.where(lvl <= max_snp[:, None, None], lvl, DEAD)
        min_mm = jnp.min(lvl_cap, axis=(1, 2))                    # [B]
        at_min = lvl == min_mm[:, None, None]
        cnt1 = jnp.sum(at_min, axis=(1, 2), dtype=jnp.int32)
        hi = jnp.minimum(min_mm + (tsec_minus - max_snp), tsec_minus)
        cntp = jnp.sum(lvl <= hi[:, None, None], axis=(1, 2),
                       dtype=jnp.int32)
        # representative: first (lane, w) in lane-major order at min level
        flat = at_min.reshape(at_min.shape[0], -1)
        rep_flat = jnp.argmax(flat, axis=1).astype(jnp.int32)
        rep_lane = rep_flat // w
        rep_w = rep_flat % w
        rep_strict_bad = jnp.take_along_axis(
            strict_bad.reshape(strict_bad.shape[0], -1),
            rep_flat[:, None], axis=1)[:, 0]
        return (cum, cum_at_end, strict_hist), (min_mm, cnt1, cntp, rep_lane,
                                                rep_w, rep_strict_bad)

    cum0 = jnp.zeros(seeded.shape, dtype=jnp.int32)
    hist0 = jnp.zeros(seeded.shape + (mpm_i,), dtype=jnp.int8)
    (_, cum_final, _), outs = jax.lax.scan(
        step, (cum0, cum0, hist0), jnp.arange(lmax, dtype=jnp.int32))
    min_mm, cnt1, cntp, rep_lane, rep_w, rep_strict_bad = [
        jnp.moveaxis(o, 0, 1) for o in outs]                      # [B, Lmax]

    b = min_mm.shape[0]
    lens = jnp.arange(1, lmax + 1, dtype=jnp.int32)[None, :]      # L per col
    in_range = (lens >= bp_start) & (lens <= qlen[:, None] - 1)
    maxmm_l = maxmm[jnp.minimum(lens, MAX_READ_LENGTH - 1)]
    stop_here = in_range & (min_mm > maxmm_l)
    stopped = jnp.cumsum(stop_here.astype(jnp.int32), axis=1) > 0
    # emission happens before the early-return at the stopping length itself
    # is taken? No: the early return fires BEFORE emission at that length.
    alive = ~stopped

    # full-read mismatch count for the representative candidate
    cum_flat = cum_final.reshape(b, -1)                           # [B, NL*W]
    rep_flat = rep_lane * w + rep_w
    full_mm = jnp.take_along_axis(cum_flat, rep_flat, axis=1)     # [B, Lmax]

    # direction-dependent MPM length rule: forward lanes need L > mpm,
    # backward lanes need L >= mpm.  Backward lanes are the reversed tiles.
    rep_reverse = jnp.take_along_axis(reverse, rep_lane, axis=1)  # [B, Lmax]
    len_ok = jnp.where(rep_reverse, lens >= mpm_i, lens > mpm_i)

    # max_allowed is precomputed host-side as float32(double(n) * double(rate))
    # to reproduce the reference's double->float rounding exactly.
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

    # ---- pack everything into ONE narrow buffer: the device→host relay
    # costs ~40ms latency per transfer + ~30MB/s, so both transfer count
    # and byte count matter.
    # full_mm is only consumed for the LAST emitted length of each read.
    lidx = jnp.arange(lmax, dtype=jnp.int32)[None, :]
    last_emit = jnp.max(jnp.where(emit, lidx, -1), axis=1)       # [B]
    full_last = jnp.take_along_axis(
        full_mm, jnp.maximum(last_emit, 0)[:, None], axis=1)[:, 0]
    full_last = jnp.where(last_emit >= 0, full_last, 0).astype(jnp.int16)

    rep_w16 = rep_w.astype(jnp.int16)
    packed = jnp.concatenate([
        emit.astype(jnp.int8),
        min_mm.astype(jnp.int8),
        rep_lane.astype(jnp.int8),
        jax.lax.bitcast_convert_type(rep_w16, jnp.int8).reshape(
            rep_w16.shape[0], -1),
        jax.lax.bitcast_convert_type(full_last[:, None], jnp.int8).reshape(
            full_last.shape[0], -1),
    ], axis=1)
    return packed


def unpack_kernel_output(packed: np.ndarray, lmax: int):
    """Host-side split of the packed kernel buffer."""
    packed = np.asarray(packed)
    emit = packed[:, :lmax].astype(bool)
    min_mm = packed[:, lmax:2 * lmax]
    rep_lane = packed[:, 2 * lmax:3 * lmax]
    rep_w = np.ascontiguousarray(
        packed[:, 3 * lmax:5 * lmax]).view(np.int16)
    full_last = np.ascontiguousarray(
        packed[:, 5 * lmax:5 * lmax + 2]).view(np.int16)[:, 0]
    return emit, min_mm, rep_lane, rep_w, full_last


@dataclasses.dataclass
class _Launch:
    w: int
    lmax: int
    nl: int


def _next_b_bucket(b: int, buckets=(256, 2048, 8192)) -> int:
    for bb in buckets:
        if b <= bb:
            return bb
    return buckets[-1]


class JaxBackend:
    """Backend with the Searcher-facing ``run`` interface.

    Batch size and window width are bucketed aggressively (each distinct
    static shape is a fresh XLA compile); batches larger
    than the top bucket are chunked.
    """

    MAX_CHUNK = 8192

    def __init__(self, settings, maxmm: np.ndarray, chrom_codes: np.ndarray,
                 w_buckets: Sequence[int] = (512, 2048, 8192, 32768),
                 chrom_name: str = None):
        self.mpm = settings.min_perfect_match_around_bp
        self.rate = settings.max_allowed_mismatch_rate
        self.maxmm_dev = jnp.asarray(maxmm, dtype=jnp.int32)
        self.chrom_dev = jax.device_put(jnp.asarray(chrom_codes))
        self.chrom_name = chrom_name   # lanes on other chromosomes fall
        self.w_buckets = tuple(sorted(w_buckets))   # back to NumPy
        enable_compile_cache()

    def _bucket(self, width: int) -> int:
        for b in self.w_buckets:
            if width <= b:
                return b
        return _round_up(width, 32768)

    def run(self, batch_lanes: List[List[Lane]], bp_start: int,
            max_snps: Sequence[int], tsec_minus: Sequence[int]
            ) -> List[Tuple[AnchorSet, int]]:
        if not batch_lanes:
            return []
        if len(batch_lanes) > self.MAX_CHUNK:
            out: List[Tuple[AnchorSet, int]] = []
            for lo in range(0, len(batch_lanes), self.MAX_CHUNK):
                hi = lo + self.MAX_CHUNK
                out.extend(self.run(batch_lanes[lo:hi], bp_start,
                                    max_snps[lo:hi], tsec_minus[lo:hi]))
            return out
        from pindel_tpu.profiling import g_timer
        t_pack = time.monotonic()
        nl = max(len(lanes) for lanes in batch_lanes)
        widths = [max((l.end - l.start) for l in lanes) if lanes else 1
                  for lanes in batch_lanes]
        w = self._bucket(max(max(widths), 1))
        qlens = [int(lanes[0].query.shape[0]) for lanes in batch_lanes]
        lmax = _round_up(max(qlens), 128)   # coarse: fewer compiled shapes
        from pindel_tpu.genome import SPACER
        assert w + lmax <= SPACER, (
            f"window bucket {w}+{lmax} exceeds spacer; chunked far-end search "
            "for very large -x not yet implemented")

        b = _next_b_bucket(len(batch_lanes))
        n_real = len(batch_lanes)
        slice_start = np.zeros((b, nl), dtype=np.int32)
        rev = np.zeros((b, nl), dtype=bool)
        qq = np.full((b, nl, lmax), dna.N, dtype=np.int8)
        valid_w = np.zeros((b, nl), dtype=np.int32)
        lane_dir_minus = np.zeros((b, nl), dtype=bool)
        lane_strand_minus = np.zeros((b, nl), dtype=bool)
        lane_fwd = np.ones((b, nl), dtype=bool)
        lane_chr = [[""] * nl for _ in range(b)]
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

        qlen_a = np.zeros(b, dtype=np.int32)
        qlen_a[:n_real] = qlens
        ms_a = np.zeros(b, dtype=np.int32)
        ms_a[:n_real] = max_snps
        tm_a = np.zeros(b, dtype=np.int32)
        tm_a[:n_real] = tsec_minus
        max_allowed = np.zeros(b, dtype=np.float32)
        max_allowed[:n_real] = np.float32(
            np.array(qlens, dtype=np.float64) * np.float64(self.rate))
        t_kernel = time.monotonic()
        g_timer.add("device: pack lanes", t_kernel - t_pack)
        packed = jax.device_get(
            _search_kernel(
                self.chrom_dev,
                jnp.asarray(slice_start), jnp.asarray(rev), jnp.asarray(qq),
                jnp.asarray(valid_w), jnp.asarray(qlen_a),
                jnp.asarray(ms_a), jnp.asarray(tm_a),
                self.maxmm_dev, jnp.asarray(max_allowed),
                w=w, lmax=lmax, nl=nl, mpm=self.mpm,
                bp_start=bp_start))
        t_decode = time.monotonic()
        g_timer.add(f"device: kernel+xfer w={w} nl={nl} b={b}",
                    t_decode - t_kernel)
        emit, min_mm, rep_lane, rep_w, full_last = unpack_kernel_output(
            packed[:n_real], lmax)

        out = decode_emissions(
            emit, min_mm, rep_lane, rep_w, full_last,
            slice_start[:n_real], w, lmax,
            lane_fwd[:n_real], lane_dir_minus[:n_real],
            lane_strand_minus[:n_real], lane_chr[:n_real])
        g_timer.add("device: decode emissions", time.monotonic() - t_decode)
        return out


def decode_emissions(emit, min_mm, rep_lane, rep_w, full_last,
                     slice_start, w: int, lmax: int, lane_fwd,
                     lane_dir_minus, lane_strand_minus, lane_chr
                     ) -> List[Tuple[AnchorSet, int]]:
    """Vectorized (read, length) → AnchorSet conversion.

    One numpy pass over all emissions; no per-anchor Python objects —
    each read gets a struct-of-arrays AnchorSet slice.  ``full_last`` is
    the whole-read mismatch count at each read's last emission ([B]).
    """
    b = emit.shape[0]
    emit = np.asarray(emit)
    flat = np.flatnonzero(emit)
    if flat.size == 0:
        return [(AnchorSet.empty(), 0) for _ in range(b)]
    rows = flat // lmax
    lcols = flat % lmax
    lengths = (lcols + 1).astype(np.int64)
    lanes_sel = np.asarray(rep_lane)[rows, lcols]
    wi = np.asarray(rep_w)[rows, lcols]
    ss = slice_start[rows, lanes_sel].astype(np.int64)
    mm = np.asarray(min_mm)[rows, lcols].astype(np.int64)
    fwd = lane_fwd[rows, lanes_sel]
    dirm = lane_dir_minus[rows, lanes_sel]
    strm = lane_strand_minus[rows, lanes_sel]
    abs_loc = np.where(
        fwd, ss + wi + lengths - 1,
        (ss + w + lmax - 1 - wi) - (lengths - 1)).astype(np.int64)

    results: List[Tuple[AnchorSet, int]] = []
    bounds = np.searchsorted(rows, np.arange(b + 1))
    cid0 = np.zeros(0, dtype=np.int8)
    for i in range(b):
        lo, hi = int(bounds[i]), int(bounds[i + 1])
        if lo == hi:
            results.append((AnchorSet.empty(), 0))
            continue
        sl = slice(lo, hi)
        lanes_i = lanes_sel[sl]
        chrs = lane_chr[i]
        if len(set(chrs)) <= 1:
            chr_names = [chrs[0]] if chrs else []
            cid = np.zeros(hi - lo, dtype=np.int8) if chrs else cid0
        else:
            chr_names = []
            lane_cid = np.empty(len(chrs), dtype=np.int8)
            for j, c in enumerate(chrs):
                if c not in chr_names:
                    chr_names.append(c)
                lane_cid[j] = chr_names.index(c)
            cid = lane_cid[lanes_i]
        results.append((AnchorSet(lengths[sl], abs_loc[sl], mm[sl],
                                  dirm[sl], strm[sl], chr_names, cid),
                        int(full_last[i])))
    return results
