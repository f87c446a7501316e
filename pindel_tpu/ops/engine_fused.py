"""Fused JAX search engine (the device hot path).

The legacy engine (ops/engine_jax.py) launches one kernel per search round
(4 close-end attempts, then each far-end escalation round) and downloads a
dense [B, 5*Lmax] stats buffer per launch.  This engine restructures the
whole per-window search into two launches:

* reads are uploaded ONCE per chunk (int8 base codes + scalar metadata);
  all query orientations (reverse, complement, reverse-complement) are
  derived on device;
* ``_close_kernel`` evaluates ALL FOUR attempts of the reference close
  schedule (GetCloseEnd, pindel.cpp:2531-2576: (range0, seq), (range0,
  RC), then (range1, RC), (range1, seq)) as lane groups with per-group
  emission statistics in ONE launch, picking the first group that emits
  — bit-equal to running the attempts sequentially because the attempts
  are independent given the read.  Each chunk is one metadata upload,
  one launch and one packed download;
* ``_far_kernel`` evaluates all geometric far-end escalation rounds
  (SearchFarEnd, pindel.cpp:1001-1074: span 64*4^k) in one launch, with
  the NewUPFarIsBetter replacement rule (farend_searcher.cpp:30-44)
  applied between rounds on device;
* the download per read is a compact record: an emission *bitmask* over
  lengths, the representative (lane, window-offset) at the last emitted
  length, and a flag saying whether the whole emitted chain shares that
  representative.  When it does (measured: ~100% of reads), the host
  reconstructs every UniquePoint exactly — positions from the (lane, w, L)
  geometry and mismatch counts from a vectorized recount against the
  chromosome.  When it does not, the read falls back to the bit-exact
  NumPy oracle (ops/search_np.py) via the Searcher.

The per-length scan keeps the dense candidate semantics proven in
ops/engine_jax.py with a two-word carry per candidate: the packed
(level << shift | index) key base, maintained by one shifted add per
step, and the step index of the last strict mismatch (the rolling
strict-window rule "a strict mismatch within mpm steps" is
``lastmm > l - mpm``).  Dead lanes START at the `dead` level instead of
being clamped per step — levels become monotone counts, which changes
no emission decision (see _xla_scan_rows).  On a CUDA device the scan is
the Triton kernel of ops/scan_triton.py.
"""
from __future__ import annotations

import dataclasses
import time
from functools import partial
from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from pindel_tpu import dna
from pindel_tpu.config import MAX_READ_LENGTH

U8DEAD = 255
I16DEAD = 1000   # > max possible cum (lmax <= 512); keeps key in int32


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _copy_to_host_async(dev) -> None:
    """Start device->host transfers as soon as the kernel output is ready,
    so the copy overlaps the remaining device work and host decode."""
    for a in dev:
        a.copy_to_host_async()


def _b_bucket(b: int, buckets=(256, 2048, 8192)) -> int:
    for bb in buckets:
        if b <= bb:
            return bb
    return buckets[-1]


# --------------------------------------------------------------------- scan
def _scan_lanes(chrom, slice_start, reverse, qq, valid_w, qlen,
                max_snp, tsec_minus, thr, *, w: int, lmax: int,
                g: int, nlg: int, mpm: int, lsteps: int = 0):
    """Dense length-scan over candidate lanes with per-group statistics.

    Shapes: slice_start/reverse/valid_w [B, NL]; qq [B, NL, lmax] with
    NL = g * nlg; qlen/max_snp/tsec_minus/thr [B] int32 (budgets <= 200;
    thr is the integer whole-read mismatch threshold equivalent to
    CheckMismatches' float comparison, searcher.cpp:383-387).

    Two passes over the tile (see _xla_scan_rows): pass 1 accumulates
    the whole-read mismatch count per candidate, turning the fit rule
    into a per-candidate key bit; pass 2 packs (level, flat_w,
    strict_bad, bad_fit) into ONE int32 key whose min over the window
    yields the min level, the representative and its flags at once,
    while the min over the remaining candidates yields the runner-up
    level — the uniqueness rule "exactly one candidate within
    min+additional levels" (searcher.cpp:171-192) is equivalent to
    runner_up > min(min+additional, tsec) and implies count-at-min == 1.

    On a CUDA device the two passes run as a Triton kernel with the carry
    in registers (ops/scan_triton.py); elsewhere as a lax.scan.

    Returns per-group stacked stats, each [B, G, lmax] (index = length-1):
      min_mm  (int32, >= DEAD when no live candidate),
      lvl2    (int32 runner-up level),
      rep_key (int32 flat (lane-within-group * w + w_off) of the first
               candidate at the min level, lane-major — the order the
               reference explores PD lists and positions),
      rep_strict_bad (bool: strict-window violation of the representative),
      fit_ok  (bool: representative passes the whole-read fit rule —
               count >= thr, the reference's inverted comparison).
    """
    nl = g * nlg
    tile_len = w + lmax
    b = qq.shape[0]
    rows = b * nl

    # 128-aligned tile load: `chrom` is the [2*NR, 128] concatenation of
    # the padded chromosome and its reverse (see _chrom_cat) — a lane's
    # tile (flipped for backward lanes) is a contiguous row-take plus a
    # per-row in-buffer offset the scan kernel applies.
    nrows2 = chrom.shape[0]
    clpad = (nrows2 // 2) * 128
    nr = _round_up(tile_len, 128) // 128 + 1
    tpad = nr * 128
    start_log = jnp.where(reverse, clpad - slice_start - tile_len,
                          slice_start)
    arow = (start_log // 128).astype(jnp.int32) \
        + jnp.where(reverse, nrows2 // 2, 0)
    off = (start_log % 128).astype(jnp.int32)
    row_idx = arow[..., None] + jnp.arange(nr, dtype=jnp.int32)
    tiles = jnp.take(chrom, row_idx.reshape(-1), axis=0,
                     mode="clip").reshape(rows, tpad)

    kmin, k2 = _scan_rows(
        tiles, qq.reshape(rows, lmax),
        valid_w.reshape(rows),
        jnp.repeat(qlen, nl), jnp.repeat(thr, nl),
        off.reshape(rows),
        w=w, lmax=lmax, mpm=mpm,
        lsteps=lsteps or lmax)
    kmin = kmin.reshape(b, g, nlg, lmax)
    k2 = k2.reshape(b, g, nlg, lmax)

    shift = _key_shift(w)
    if nlg == 1:
        kmin_g = kmin[:, :, 0]
        lvl2 = k2[:, :, 0] >> shift
    else:
        # lane-major merge within each group: candidates of lane j rank
        # after equal-level candidates of lane i<j (PD exploration order)
        lvl_l = kmin >> shift                       # [B,G,NLg,L]
        kmin_g = kmin[:, :, 0]
        lvl2_g = k2[:, :, 0] >> shift
        lane_of = jnp.zeros(kmin_g.shape, jnp.int32)
        for j in range(1, nlg):
            lj = lvl_l[:, :, j]
            better = lj < (kmin_g >> shift)
            lvl2_g = jnp.where(better,
                               jnp.minimum(k2[:, :, j] >> shift,
                                           kmin_g >> shift),
                               jnp.minimum(lvl2_g, lj))
            lane_of = jnp.where(better, j, lane_of)
            kmin_g = jnp.where(better, kmin[:, :, j], kmin_g)
        lvl2 = lvl2_g
    min_mm = kmin_g >> shift
    rep_w = (kmin_g >> 2) & ((1 << (shift - 2)) - 1)
    rep_key = rep_w if nlg == 1 else lane_of * w + rep_w
    rep_strict_bad = (kmin_g & 2) == 2
    fit_ok = (kmin_g & 1) == 0
    return min_mm, lvl2, rep_key, rep_strict_bad, fit_ok


def _key_shift(w: int) -> int:
    wbits = max(int(np.ceil(np.log2(w))), 1)
    return wbits + 2


def _scan_rows(tiles, qq, valid_w, qlen, thr, off,
               *, w: int, lmax: int, mpm: int, lsteps: int = 0):
    """Per-row packed-key scan: [R, T] tiles -> (kmin, k2) — [R, lmax]
    int32 packed keys (level << shift | window_offset << 2 |
    strict_bad << 1 | fitbad).

    Tiles are 128-aligned row-takes of the chromosome with per-row
    window start ``off`` in [0, 128); lane space WE = T - lmax.

    ``lsteps`` bounds the scan to the longest real query (lengths beyond
    it cannot emit: in_range needs length <= qlen-1 <= lsteps); the
    outputs stay [R, lmax] with zeros past lsteps.

    The implementation is chosen when the function is lowered: the
    Triton kernel (ops/scan_triton.py) for a CUDA device, the XLA twin
    for any other, so one jitted kernel lowers either way."""
    from pindel_tpu.ops.scan_triton import triton_scan_rows
    static = dict(w=w, lmax=lmax, mpm=mpm, lsteps=lsteps or lmax)
    return jax.lax.platform_dependent(
        tiles, qq, valid_w, qlen, thr, off,
        cuda=partial(triton_scan_rows, **static),
        default=partial(_xla_scan_rows, **static))


NEVER = -(1 << 20)   # lastmm sentinel: no strict mismatch yet
MAXI = 2 ** 31 - 1   # runner-up placeholder for the min-key lanes


def _xla_scan_rows(tiles, qq, valid_w, qlen, thr, off,
                   *, w: int, lmax: int, mpm: int, lsteps: int = 0):
    """The scan in plain XLA: the reference the Triton kernel
    (ops/scan_triton.py) must match bit for bit.

    Pass 1 accumulates each candidate's whole-read mismatch count (the
    CheckMismatches fit input, searcher.cpp:383-387); the fit bit
    ``totals < thr`` rides bit 0 of the key.  Pass 2 is the scan proper
    with two int32 words of state per candidate:

    * the packed key base (level << shift | window_offset << 2 | fitbad),
      one shifted add per step.  Dead lanes (not seeded) START at the
      ``dead`` level: levels are monotone counts rather than saturated
      ones, which changes no emission decision because every rule that
      consumes a level first tests it against budgets <= tsec < dead
      (see _emit_rules).  Dead lanes outside [off, off+w) have their
      offset clamped into [0, w): they can collide with live offsets,
      which is harmless because their level keeps them above every
      consumed threshold;
    * ``lastmm``, the step of the most recent strict mismatch (steps >= 1
      only): the strict window rule "a strict mismatch in the last mpm
      steps" is ``lastmm > l - mpm``.

    Per length, the min key gives level, representative, strict flag and
    fit bit at once; the min over the other keys gives the runner-up
    level for the uniqueness rule."""
    lsteps = lsteps or lmax
    dead = U8DEAD if lmax <= 255 else I16DEAD
    shift = _key_shift(w)
    assert ((dead + lmax) << shift) + (1 << shift) < 2 ** 31, (w, lmax)
    r, t = tiles.shape
    we = t - lmax
    assert we >= w, (t, w, lmax)
    off_c = off[:, None]

    # pass 1: whole-read mismatch totals per candidate -> fit bit
    def total_body(tot, l):
        ref = jax.lax.dynamic_slice_in_dim(tiles, l, we, axis=1)
        qb = jax.lax.dynamic_slice_in_dim(qq, l, 1, axis=1)
        mm = ((ref != qb) ^ (qb == dna.N)) & ((l >= 1) & (l < qlen[:, None]))
        return tot + mm.astype(jnp.int32), None

    totals, _ = jax.lax.scan(total_body, jnp.zeros((r, we), jnp.int32),
                             jnp.arange(lsteps, dtype=jnp.int32))
    fitbad = (totals < thr[:, None]).astype(jnp.int32)

    widx = jnp.arange(we, dtype=jnp.int32)[None, :]
    seeded = ((tiles[:, :we] == qq[:, 0:1]) & (widx >= off_c)
              & (widx < off_c + valid_w[:, None]))
    seeded &= (qq[:, 0:1] != dna.N)
    woff = jnp.clip(widx - off_c, 0, w - 1)
    keybase0 = (jnp.where(seeded, 0, jnp.int32(dead)) << shift) \
        | (woff << 2) | fitbad

    def body(carry, l):
        keybase, lastmm = carry
        ref = jax.lax.dynamic_slice_in_dim(tiles, l, we, axis=1)
        qb = jax.lax.dynamic_slice_in_dim(qq, l, 1, axis=1)
        d = ref != qb
        mm = (d ^ (qb == dna.N)) & ((l >= 1) & (l < qlen[:, None]))
        keybase = keybase + (mm.astype(jnp.int32) << shift)
        lastmm = jnp.where(
            d, jax.lax.select(l >= 1, l, jnp.int32(NEVER)), lastmm)
        key = keybase + ((lastmm > l - mpm).astype(jnp.int32) << 1)
        kmin = jnp.min(key, axis=1)
        k2 = jnp.min(jnp.where(key == kmin[:, None],
                               jnp.int32(MAXI), key), axis=1)
        return (keybase, lastmm), (kmin, k2)

    lm0 = jnp.full((r, we), NEVER, jnp.int32)
    _, (kmin, k2) = jax.lax.scan(
        body, (keybase0, lm0), jnp.arange(lsteps, dtype=jnp.int32))
    pad = ((0, 0), (0, lmax - lsteps))
    return (jnp.pad(jnp.moveaxis(kmin, 0, 1), pad),
            jnp.pad(jnp.moveaxis(k2, 0, 1), pad))


def _emit_rules(min_mm, lvl2, rep_key, rep_strict_bad, fit_ok,
                reverse, qlen, max_snp, tsec_minus, maxmm,
                *, w: int, lmax: int, g: int, nlg: int, mpm: int,
                bp_start: int):
    """Per-(group, length) emission decision (CheckLeft/Right_Close +
    CheckBoth + CheckMismatches; see ops/search_np.py for the rule map).

    reverse: [B, NL] lane tile-reversal flags (NL = g*nlg).
    Returns emit [B,G,L] plus chain summary: rep at last emission,
    uniformity, any-emission, index of last emission.
    """
    dead = U8DEAD if lmax <= 255 else I16DEAD
    lens = jnp.arange(1, lmax + 1, dtype=jnp.int32)[None, None, :]
    in_range = (lens >= bp_start) & (lens <= qlen[:, None, None] - 1)
    maxmm_l = maxmm[jnp.minimum(lens, MAX_READ_LENGTH - 1)]
    min_live = jnp.where(min_mm >= dead, jnp.int32(10 ** 6), min_mm)
    stop_here = in_range & (min_live > maxmm_l)
    alive = jnp.cumsum(stop_here.astype(jnp.int32), axis=2) == 0

    g_dim = min_mm.shape[1]
    # representative's reverse flag, gather-free: all lanes of a close-end
    # group share one flag; far-end groups have few lanes (one-hot select)
    if nlg == 1:
        rev_rep = reverse.reshape(reverse.shape[0], g_dim, 1)
    else:
        rep_lane_rel = rep_key // w                               # [B,G,L]
        rev_g = reverse.reshape(reverse.shape[0], g_dim, 1, nlg)
        onehot = rep_lane_rel[..., None] == jnp.arange(
            nlg, dtype=jnp.int32)
        rev_rep = jnp.any(onehot & rev_g, axis=-1)
    len_ok = jnp.where(rev_rep, lens >= mpm, lens > mpm)

    # "exactly one candidate at the min level, none within min+additional
    # levels" (searcher.cpp:171-192) == runner-up beyond min(min+add, tsec)
    hi = jnp.minimum(min_live + (tsec_minus - max_snp)[:, None, None],
                     tsec_minus[:, None, None])
    unique_ok = lvl2 > hi

    emit = (in_range & alive
            & (min_live <= max_snp[:, None, None])
            & (lens >= bp_start + min_live)
            & unique_ok
            & (min_live <= maxmm_l)
            & len_ok
            & ~rep_strict_bad
            & fit_ok)

    lidx = jnp.arange(lmax, dtype=jnp.int32)[None, None, :]
    last = jnp.max(jnp.where(emit, lidx, -1), axis=2)             # [B,G]
    any_emit = last >= 0
    rep_last = jnp.take_along_axis(
        rep_key, jnp.maximum(last, 0)[:, :, None], axis=2)[:, :, 0]
    uniform = jnp.all(~emit | (rep_key == rep_last[:, :, None]), axis=2)
    return emit, rep_last, uniform, any_emit, last


@jax.jit
def _chrom_cat(chrom):
    """[CL] int8 chromosome -> [2*NR, 128]: 128-padded rows of the
    chromosome followed by the rows of its reverse.  Kernel tile loads
    (forward and flipped) become contiguous row-takes of this array."""
    cl = chrom.shape[0]
    clpad = _round_up(cl, 128)
    fwd = jnp.concatenate(
        [chrom, jnp.full((clpad - cl,), dna.N, jnp.int8)])
    return jnp.concatenate([fwd.reshape(-1, 128),
                            jnp.flip(fwd).reshape(-1, 128)])


def _pack_words(emit):
    """[..., L] bool -> [..., L/32] int32 (little-endian within a word).

    The whole per-read result of a launch is packed into ONE int32 row
    (emission words + representative + flags) so a chunk's download is a
    single transfer."""
    shp = emit.shape
    e = emit.reshape(shp[:-1] + (shp[-1] // 32, 32)).astype(jnp.uint32)
    words = (e << jnp.arange(32, dtype=jnp.uint32)).sum(
        axis=-1, dtype=jnp.uint32)
    return jax.lax.bitcast_convert_type(words, jnp.int32)


def _complement(codes):
    # arithmetic base complement (A<->T, C<->G, N->N): codes 0..3 map to
    # 3-c, N(4) stays — an elementwise select instead of a table gather
    c = codes.astype(jnp.int32)
    return jnp.where(c == dna.N, c, 3 - c).astype(jnp.int8)


def _reverse_codes_np(codes: np.ndarray, qlen: np.ndarray) -> np.ndarray:
    """Reverse each row within its qlen (padding stays N at the tail),
    on the host: the payload ships this second 4-bit copy instead of a
    per-row gather on the device."""
    b, lmax = codes.shape
    li = np.arange(lmax)[None, :]
    valid = li < qlen[:, None]
    idx = np.where(valid, np.maximum(qlen[:, None] - 1 - li, 0), li)
    out = np.take_along_axis(codes, idx, axis=1)
    return np.where(valid, out, np.int8(dna.N)).astype(np.int8)


# --------------------------------------------------- payload pack/unpack
# Each chunk ships ONE int8 payload: 4-bit-packed base codes (2
# bases/byte) followed by bit-packed per-read metadata (3 int32 words for
# close, 4 for far).  The pack itself runs in native code
# (native/packer.cpp) — it sits on the dispatch critical path.

_PACKLIB = None


def _packer():
    global _PACKLIB
    if _PACKLIB is None:
        import ctypes

        from pindel_tpu import native
        lib = native.load("ptpack", ["packer.cpp"], link=())
        for fn in ("pt_pack_close", "pt_pack_far"):
            getattr(lib, fn).argtypes = [
                ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
                ctypes.c_int64, ctypes.c_void_p]
        lib.pt_codes.argtypes = [
            ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p]
        lib.pt_pack_close_at.argtypes = [
            ctypes.c_char_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
        lib.pt_codes_at.argtypes = [
            ctypes.c_char_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p]
        _PACKLIB = lib
    return _PACKLIB


def _seq_blob(reads, nb: int):
    """(concatenated latin-1 sequence bytes, int64 offsets[nb+1])."""
    blob = "".join(r.seq for r in reads).encode("latin-1")
    offs = np.zeros(nb + 1, np.int64)
    np.cumsum(np.fromiter((len(r.seq) for r in reads), np.int64, nb),
              out=offs[1:])
    return blob, offs


def _ptr(a: np.ndarray):
    import ctypes
    return ctypes.c_void_p(a.ctypes.data)


def _native_pack_close(blob: bytes, offs: np.ndarray, nb: int, b: int,
                       lmax: int, meta32: np.ndarray) -> np.ndarray:
    out = np.empty((b, lmax + 4 * meta32.shape[1]), np.int8)
    m = np.ascontiguousarray(meta32.astype("<i4"))
    _packer().pt_pack_close(blob, _ptr(offs), nb, b, lmax, _ptr(m),
                            m.shape[1], _ptr(out))
    return out


def _native_pack_far(blob: bytes, offs: np.ndarray, nb: int, b: int,
                     lmax: int, meta32: np.ndarray) -> np.ndarray:
    out = np.empty((b, lmax // 2 + 4 * meta32.shape[1]), np.int8)
    m = np.ascontiguousarray(meta32.astype("<i4"))
    _packer().pt_pack_far(blob, _ptr(offs), nb, b, lmax, _ptr(m),
                          m.shape[1], _ptr(out))
    return out


def _native_codes(blob: bytes, offs: np.ndarray, nb: int, b: int,
                  lmax: int) -> np.ndarray:
    out = np.empty((b, lmax), np.int8)
    _packer().pt_codes(blob, _ptr(offs), nb, b, lmax, _ptr(out))
    return out


def _native_pack_close_at(blob: bytes, off: np.ndarray, ln: np.ndarray,
                          nb: int, b: int, lmax: int,
                          meta32: np.ndarray) -> np.ndarray:
    """pt_pack_close over per-read (offset, length) pairs into an
    arbitrary record buffer (lazy ReadBatch path)."""
    out = np.empty((b, lmax + 4 * meta32.shape[1]), np.int8)
    m = np.ascontiguousarray(meta32.astype("<i4"))
    _packer().pt_pack_close_at(blob, _ptr(off), _ptr(ln), nb, b, lmax,
                               _ptr(m), m.shape[1], _ptr(out))
    return out


def _native_codes_at(blob: bytes, off: np.ndarray, ln: np.ndarray,
                     nb: int, b: int, lmax: int) -> np.ndarray:
    out = np.empty((b, lmax), np.int8)
    _packer().pt_codes_at(blob, _ptr(off), _ptr(ln), nb, b, lmax,
                          _ptr(out))
    return out

def _pack_payload(codes: np.ndarray, meta32: np.ndarray) -> np.ndarray:
    """[b, lmax] int8 codes + [b, K] int32 meta -> [b, lmax//2+4K] int8."""
    a = codes.astype(np.uint8)
    packed = (a[:, 0::2] | (a[:, 1::2] << 4)).view(np.int8)
    return np.concatenate([packed, meta32.astype("<i4").view(np.int8)
                           .reshape(codes.shape[0], -1)], axis=1)


def _unpack_payload(payload, lmax: int, nmeta: int):
    """Device-side inverse of _pack_payload -> (codes [b,lmax] int8,
    meta [b,nmeta] int32)."""
    b = payload.shape[0]
    p32 = payload[:, :lmax // 2].astype(jnp.int32)
    codes = jnp.stack([p32 & 15, (p32 >> 4) & 15], axis=-1) \
        .reshape(b, lmax).astype(jnp.int8)
    meta = jax.lax.bitcast_convert_type(
        payload[:, lmax // 2:].reshape(b, nmeta, 4), jnp.int32)
    return codes, meta


# ------------------------------------------------------------ close kernel
# close meta words: [0] anchor pos; [1] insert_size | qlen<<17;
# [2] ms | tm<<8 | thr<<16 | minus<<26
CM_WORDS = 3


def _close_meta(pos, isz, qlen, ms, tm, thr, minus) -> np.ndarray:
    m = np.zeros((pos.shape[0], CM_WORDS), np.int32)
    m[:, 0] = pos
    m[:, 1] = isz | (qlen.astype(np.int64) << 17)
    m[:, 2] = (ms | (tm.astype(np.int64) << 8)
               | (thr.astype(np.int64) << 16)
               | (minus.astype(np.int64) << 26))
    return m


def _close_kernel(chrom, payload, maxmm,
                  *, w0: int, w1: int, lmax: int, mpm: int, bp_start: int,
                  lsteps: int, with_r1: bool):
    """ALL FOUR close-end attempts in one launch.

    Attempt schedule (GetCloseEnd, pindel.cpp:2531-2576): (range0, seq),
    (range0, RC), then — only when range 0 found no unique point —
    (range1, RC), (range1, seq).  Both ranges are scanned
    unconditionally and merged on device with range-0 precedence, which
    is bit-equal to running them sequentially because the attempts are
    independent given the read; range 1 is computed even for range-0
    successes, which saves a compacted second launch.

    Per the lane construction (close_end_lane in search.py,
    GetCloseEndInner pindel.cpp:2271-2316): a '+'-anchored read searches
    a *forward* tile with the reverse complement of the current sequence;
    a '-' read a *backward* tile with the current sequence (which the
    tile convention reverses).  Expressed in the uploaded original codes
    f, the device-oriented queries are:

        '+' read, attempts 0..3: qq = [RC(f), f,    f,    RC(f)]
        '-' read, attempts 0..3: qq = [R(f),  C(f), C(f), R(f)]

    where R = reverse-within-qlen and C = base complement.

    Inputs: payload (see _pack_payload: 4-bit codes of BOTH the original
    and the host-reversed sequence + CM_WORDS meta — the within-qlen
    reversal is done on the host, see _reverse_codes_np).  Output: ONE
    int32 array [B, lmax//32 + 2]: emission words of the winning attempt,
    its representative, and flags = winner(0..3 or 255) | uniform << 8.
    """
    from pindel_tpu.genome import SPACER
    codes2, meta = _unpack_payload(payload, 2 * lmax, CM_WORDS)
    pos = meta[:, 0]
    isz = meta[:, 1] & 0x1ffff
    qlen = meta[:, 1] >> 17
    ms = meta[:, 2] & 0xff
    tm = (meta[:, 2] >> 8) & 0xff
    thr = (meta[:, 2] >> 16) & 0x3ff
    minus = ((meta[:, 2] >> 26) & 1).astype(bool)
    f = codes2[:, :lmax]
    rf = codes2[:, lmax:]          # reverse-within-qlen, host-computed
    cf = _complement(f)
    rcf = _complement(rf)          # reverse and complement commute
    mm_col = minus[:, None]
    q_orig = jnp.where(mm_col, rf, rcf)   # attempt with original sequence
    q_flip = jnp.where(mm_col, cf, f)     # attempt with RC'd sequence

    def one_range(k, w, qa, qb):
        # attempt windows (close_end_lane geometry, pindel.cpp:2271-2316)
        plus_start = pos + SPACER - k * isz
        minus_end = pos + SPACER + k * isz
        start = jnp.where(minus, minus_end - (2 * k + 1) * isz, plus_start)
        end = jnp.where(minus, minus_end, plus_start + (2 * k + 1) * isz)
        ss = jnp.where(minus, end - (w + lmax), start)
        valid = jnp.clip(end - start, 0, w)
        qq = jnp.stack([qa, qb], axis=1)                         # [B,2,L]
        slice_start = jnp.stack([ss, ss], axis=1)
        reverse = jnp.stack([minus, minus], axis=1)
        valid_w = jnp.stack([valid, valid], axis=1)
        stats = _scan_lanes(chrom, slice_start, reverse, qq, valid_w,
                            qlen, ms, tm, thr,
                            w=w, lmax=lmax, g=2, nlg=1, mpm=mpm,
                            lsteps=lsteps)
        emit, rep_last, uniform, any_emit, _last = _emit_rules(
            *stats, reverse, qlen, ms, tm, maxmm,
            w=w, lmax=lmax, g=2, nlg=1, mpm=mpm, bp_start=bp_start)
        winner = jnp.argmax(any_emit, axis=1).astype(jnp.int32)  # first hit
        has = jnp.any(any_emit, axis=1)
        emit_w = jnp.take_along_axis(
            emit, winner[:, None, None], axis=1)[:, 0]
        rep_w = jnp.take_along_axis(rep_last, winner[:, None], axis=1)[:, 0]
        uni_w = jnp.take_along_axis(uniform, winner[:, None], axis=1)[:, 0]
        return has, winner, emit_w, rep_w, uni_w

    has0, win0, emit0, rep0, uni0 = one_range(0, w0, q_orig, q_flip)
    if with_r1:
        has1, win1, emit1, rep1, uni1 = one_range(1, w1, q_flip, q_orig)
        use1 = ~has0
        emit = jnp.where(use1[:, None], emit1, emit0)
        rep = jnp.where(use1, rep1, rep0)
        uni = jnp.where(use1, uni1, uni0)
        winner = jnp.where(has0, win0,
                           jnp.where(has1, win1 + 2, 255))
    else:
        emit, rep, uni = emit0, rep0, uni0
        winner = jnp.where(has0, win0, 255)
    words = _pack_words(emit)
    flags = winner | (uni.astype(jnp.int32) << 8)
    return jnp.concatenate(
        [words, rep[:, None].astype(jnp.int32), flags[:, None]], axis=1)


# -------------------------------------------------------------- far kernel
# far meta words: [0] close-end center; [1] qlen | close_max<<10 |
# init_max<<20; [2] ms | tm<<8 | thr<<16; [3] padded chromosome size
FM_WORDS = 4


def _far_meta(center, qlen, close_max, init_max, ms, tm, thr,
              comp_size: int) -> np.ndarray:
    m = np.zeros((center.shape[0], FM_WORDS), np.int32)
    m[:, 0] = center
    m[:, 1] = (qlen.astype(np.int64) | (close_max.astype(np.int64) << 10)
               | (init_max.astype(np.int64) << 20))
    m[:, 2] = (ms | (tm.astype(np.int64) << 8)
               | (thr.astype(np.int64) << 16))
    m[:, 3] = comp_size
    return m


def _far_kernel(chrom, payload, maxmm,
                *, spans: Tuple[int, ...], ws: Tuple[int, ...], lmax: int,
                mpm: int, bp_start: int, lsteps: int = 0):
    """All geometric far-end escalation rounds in one launch.

    Lane construction (far_end_lanes in search.py / SearchFarEndAtPos,
    farend_searcher.cpp:46-103): lane 0 = forward tile with the current
    sequence, lane 1 = backward tile with its reverse complement (which
    the tile convention reverses back to the plain complement).  ``codes``
    already hold the read's *current* (possibly close-end-flipped)
    sequence.

    payload: see _pack_payload (4-bit codes + FM_WORDS meta); spans/ws:
    static per-round half-spans and window buckets.  State between
    rounds follows the legacy driver (search.py): a read is searched in
    round r iff close_max + far_max < qlen (goodFarEndFound,
    pindel.cpp:480-483); the round result replaces the current one iff
    new_max >= far_max (NewUPFarIsBetter, farend_searcher.cpp:30-44).

    Output: ONE int32 array [B, lmax//32 + 2]: emission words, rep, and
    flags = round(0..R-1 or 255) | replaced << 8 | uniform << 9.
    """
    from pindel_tpu.genome import SPACER
    codes, meta = _unpack_payload(payload, lmax, FM_WORDS)
    b = codes.shape[0]
    center = meta[:, 0]
    qlen = meta[:, 1] & 0x3ff
    close_max = (meta[:, 1] >> 10) & 0x3ff
    ms = meta[:, 2] & 0xff
    tm = (meta[:, 2] >> 8) & 0xff
    thr = (meta[:, 2] >> 16) & 0x3ff
    comp_size = meta[:, 3]
    q0 = codes                            # forward lane: current sequence
    q1 = _complement(codes)               # backward lane: R(RC(cur)) = C(cur)

    st_emit = jnp.zeros((b, lmax), dtype=bool)
    st_rep = jnp.zeros((b,), dtype=jnp.int32)
    st_uni = jnp.ones((b,), dtype=bool)
    st_max = (meta[:, 1] >> 20) & 0x3ff
    st_round = jnp.full((b,), 255, dtype=jnp.int32)
    st_replaced = jnp.zeros((b,), dtype=bool)

    for r, (span, wb) in enumerate(zip(spans, ws)):
        # window geometry: search.py search_far_ends
        start = jnp.where(center > span + SPACER, center - span, SPACER)
        end = jnp.maximum(jnp.minimum(center + span, comp_size - SPACER),
                          start)
        qq = jnp.stack([q0, q1], axis=1)
        slice_start = jnp.stack([start, end - (wb + lmax)], axis=1)
        reverse = jnp.stack([jnp.zeros((b,), bool), jnp.ones((b,), bool)],
                            axis=1)
        valid = jnp.clip(end - start, 0, wb)
        valid_w = jnp.stack([valid, valid], axis=1)
        stats = _scan_lanes(chrom, slice_start, reverse, qq, valid_w,
                            qlen, ms, tm, thr,
                            w=wb, lmax=lmax, g=1, nlg=2, mpm=mpm,
                            lsteps=lsteps)
        emit, rep_last, uniform, any_emit, last = _emit_rules(
            *stats, reverse, qlen, ms, tm, maxmm,
            w=wb, lmax=lmax, g=1, nlg=2, mpm=mpm, bp_start=bp_start)
        emit = emit[:, 0]
        rep_last = rep_last[:, 0]
        uniform = uniform[:, 0]
        new_max = jnp.where(any_emit[:, 0], last[:, 0] + 1, 0)

        active = close_max + st_max < qlen
        replace = active & (new_max >= st_max)
        st_emit = jnp.where(replace[:, None], emit, st_emit)
        st_rep = jnp.where(replace, rep_last, st_rep)
        st_uni = jnp.where(replace, uniform, st_uni)
        st_max = jnp.where(replace, new_max, st_max)
        st_round = jnp.where(replace, r, st_round)
        st_replaced = st_replaced | replace

    words = _pack_words(st_emit)
    flags = (st_round | (st_replaced.astype(jnp.int32) << 8)
             | (st_uni.astype(jnp.int32) << 9))
    return jnp.concatenate(
        [words, st_rep[:, None], flags[:, None]], axis=1)


# ------------------------------------------------- explicit-window kernel
# meta words for _far_win_kernel: [0] window start; [1] window end;
# [2] qlen; [3] ms | tm<<8 | thr<<16
FW_WORDS = 4


def _far_win_kernel(chrom, payload, maxmm,
                    *, w: int, lmax: int, mpm: int, bp_start: int,
                    lsteps: int = 0):
    """One both-strand far-end search round over EXPLICIT per-read
    windows — the BreakDancer/RP evidence-window path
    (getCorrespondingSearchWindowCluster -> SearchFarEndAtPos,
    farend_searcher.cpp:46-103) for the common single-window case.
    Same lane construction and emission semantics as one _far_kernel
    round; replacement against prior results happens on host
    (NewUPFarIsBetter, _far_round in search.py).

    Output: ONE int32 array [B, lmax//32 + 2]: emission words, rep,
    flags = any_emit | uniform << 1.
    """
    codes, meta = _unpack_payload(payload, lmax, FW_WORDS)
    b = codes.shape[0]
    start = meta[:, 0]
    end = meta[:, 1]
    qlen = meta[:, 2]
    ms = meta[:, 3] & 0xff
    tm = (meta[:, 3] >> 8) & 0xff
    thr = (meta[:, 3] >> 16) & 0x3ff
    q0 = codes
    q1 = _complement(codes)
    qq = jnp.stack([q0, q1], axis=1)
    slice_start = jnp.stack([start, end - (w + lmax)], axis=1)
    reverse = jnp.stack([jnp.zeros((b,), bool), jnp.ones((b,), bool)],
                        axis=1)
    valid = jnp.clip(end - start, 0, w)
    valid_w = jnp.stack([valid, valid], axis=1)
    stats = _scan_lanes(chrom, slice_start, reverse, qq, valid_w,
                        qlen, ms, tm, thr,
                        w=w, lmax=lmax, g=1, nlg=2, mpm=mpm,
                        lsteps=lsteps)
    emit, rep_last, uniform, any_emit, _last = _emit_rules(
        *stats, reverse, qlen, ms, tm, maxmm,
        w=w, lmax=lmax, g=1, nlg=2, mpm=mpm, bp_start=bp_start)
    words = _pack_words(emit[:, 0])
    flags = (any_emit[:, 0].astype(jnp.int32)
             | (uniform[:, 0].astype(jnp.int32) << 1))
    return jnp.concatenate(
        [words, rep_last[:, 0:1], flags[:, None]], axis=1)


_close_kernel_jit = partial(jax.jit, static_argnames=(
    "w0", "w1", "lmax", "mpm", "bp_start", "lsteps",
    "with_r1"))(_close_kernel)
_far_win_kernel_jit = partial(jax.jit, static_argnames=(
    "w", "lmax", "mpm", "bp_start", "lsteps"))(_far_win_kernel)
_far_kernel_jit = partial(jax.jit, static_argnames=(
    "spans", "ws", "lmax", "mpm", "bp_start", "lsteps"))(_far_kernel)


# --------------------------------------------------------------- host side
def unpack_words(words: np.ndarray, lmax: int) -> np.ndarray:
    """[..., L/32] int32 -> [..., L] bool (inverse of _pack_words)."""
    u = np.asarray(words).view(np.uint32)
    bits = (u[..., :, None] >> np.arange(32, dtype=np.uint32)) & 1
    return bits.reshape(*words.shape[:-1], -1)[..., :lmax].astype(bool)


@dataclasses.dataclass
class ChainDecode:
    """One read's reconstructed anchor chain (all points share one
    representative candidate; lengths come from the emission bitmask)."""

    lengths: np.ndarray        # int64 [n]
    abs_loc: np.ndarray        # int64 [n]
    mm: np.ndarray             # int64 [n]
    full_mm: int               # whole-read mismatches of the chain


def decode_chains(chrom_codes: np.ndarray, emit: np.ndarray,
                  w_off: np.ndarray, slice_start: np.ndarray,
                  tile_reverse: np.ndarray, queries: np.ndarray,
                  qlen: np.ndarray, wbuck: np.ndarray, lmax: int
                  ) -> List[Optional[ChainDecode]]:
    """Vectorized reconstruction of uniform chains.

    Inputs are per-read, already gathered for the winning attempt/round:
    w_off is the representative's within-window offset, slice_start /
    tile_reverse the winning lane's tile geometry, queries the
    device-oriented qq rows ([N, lmax] int8) and wbuck the per-read
    window bucket.  The mismatch recount reproduces the device rule
    exactly: seed step contributes 0; Matches() semantics for N.

    ``abs_loc`` is filled from the lane geometry in the same batched
    pass: a forward lane's anchor at length ll ends at ss + w_off + ll-1,
    a backward (tile-reversed) lane's at ss + tlen-1 - w_off - (ll-1).
    All chain arrays are slice views into shared batch arrays.
    """
    n = emit.shape[0]
    out: List[Optional[ChainDecode]] = [None] * n
    idx = np.flatnonzero(emit.any(axis=1))
    if idx.size == 0:
        return out
    woff = w_off[idx].astype(np.int64)
    ss = slice_start[idx].astype(np.int64)
    rev = tile_reverse[idx]
    wb = wbuck[idx].astype(np.int64)
    ql = qlen[idx].astype(np.int64)
    tlen = wb + lmax

    # ref row step l: tile[w_off + l]; tile = chrom[ss:ss+tlen], flipped
    # when the lane is a backward lane
    l = np.arange(lmax, dtype=np.int64)[None, :]
    pos = np.where(rev[:, None],
                   ss[:, None] + tlen[:, None] - 1 - (woff[:, None] + l),
                   ss[:, None] + woff[:, None] + l)
    ref = chrom_codes[np.clip(pos, 0, chrom_codes.shape[0] - 1)]
    q = queries[idx]
    step_mm = ~dna.matches(q, ref)
    step_mm[:, 0] = False                                   # seed step
    step_mm &= l < ql[:, None]
    # mm of q[0:l+1]; counts are bounded by lmax so int32 suffices (the
    # consumers upcast into their own int64 columns)
    cum = np.cumsum(step_mm, axis=1, dtype=np.int32)
    full = cum[np.arange(idx.size), np.maximum(ql - 1, 0)]

    # split the emitted (row, length) pairs per read in one pass
    rows, cols = np.nonzero(emit[idx])
    lens_all = cols + 1
    mm_all = cum[rows, cols]
    # forward: ss+woff + (ll-1); backward: ss+tlen - woff - ll
    loc_base = np.where(rev, ss + tlen - woff, ss + woff)   # per read
    loc_all = np.where(rev[rows],
                       loc_base[rows] - lens_all,
                       loc_base[rows] + lens_all - 1)
    bounds = np.searchsorted(rows, np.arange(idx.size + 1))
    fulli = full.tolist()
    for k, i in enumerate(idx):
        sl = slice(bounds[k], bounds[k + 1])
        out[i] = ChainDecode(
            lengths=lens_all[sl],
            abs_loc=loc_all[sl],
            mm=mm_all[sl],
            full_mm=fulli[k])
    return out


class FusedJaxBackend:
    """Per-window fused search backend.

    ``close_ends``/``far_ends`` take SplitRead batches directly; the
    legacy per-lane ``run`` API (used for BreakDancer windows and for the
    cross-chromosome fallback plumbing) delegates to a contained legacy
    ``JaxBackend`` sharing the chromosome device buffer.
    """

    # batch buckets: each is one compiled shape; the ladder keeps padding
    # waste <= ~25%
    B_BUCKETS = (256, 2048, 4096, 8192, 12288, 16384, 24576, 32768,
                 49152, 65536)

    def __init__(self, settings, maxmm: np.ndarray, chrom_codes: np.ndarray,
                 chrom_name: str = None):
        from pindel_tpu.compile_cache import enable_compile_cache
        from pindel_tpu.ops.engine_jax import JaxBackend
        enable_compile_cache()
        self.settings = settings
        self.mpm = settings.min_perfect_match_around_bp
        self.rate = settings.max_allowed_mismatch_rate
        self.maxmm = np.asarray(maxmm, dtype=np.int32)
        self.maxmm_dev = jnp.asarray(self.maxmm)
        self.chrom_codes = np.asarray(chrom_codes)
        self.chrom_dev = jax.device_put(jnp.asarray(chrom_codes))
        # [2*NR, 128] aligned layout for the kernels' row-take tile loads
        # (built on device: upload stays one chromosome copy)
        self.chromcat_dev = _chrom_cat(self.chrom_dev)
        self.chrom_name = chrom_name
        self._legacy = JaxBackend.__new__(JaxBackend)
        self._legacy.mpm = self.mpm
        self._legacy.rate = self.rate
        self._legacy.maxmm_dev = self.maxmm_dev
        self._legacy.chrom_dev = self.chrom_dev
        self._legacy.chrom_name = chrom_name
        self._legacy.w_buckets = (512, 2048, 8192, 32768)
        self._pool = None
        self._pool_tried = False

    def _decode_pool(self):
        """Worker pool for host-side chain decode (gated on -T>1): the
        decode of one chunk overlaps the device wait of the next.  The
        writes are to disjoint result slots, and the future is joined
        before the chunk's results are consumed."""
        if not self._pool_tried:
            self._pool_tried = True
            from pindel_tpu.events.detect import get_num_threads
            if get_num_threads() > 1:
                from concurrent.futures import ThreadPoolExecutor
                self._pool = ThreadPoolExecutor(max_workers=1)
        return self._pool

    # legacy per-lane API (BreakDancer windows, odd shapes)
    def run(self, batch_lanes, bp_start, max_snps, tsec_minus):
        """The canonical evidence-window shape — one (forward, backward)
        lane pair over a single same-chromosome window per read
        (far_end_lanes in search.py) — takes the packed-IO
        _far_win_kernel; anything else (multi-window clusters, foreign
        chromosomes, close-end fallback lanes) delegates to the legacy
        per-lane backend."""
        n = len(batch_lanes)
        if n == 0:
            return []
        from pindel_tpu.genome import SPACER
        canonical = all(
            len(lanes) == 2 and lanes[0].forward and not lanes[1].forward
            and lanes[0].chr_name == self.chrom_name
            and lanes[1].chr_name == self.chrom_name
            and lanes[0].start == lanes[1].start
            and lanes[0].end == lanes[1].end
            and lanes[0].query.shape[0] <= 0x3ff
            for lanes in batch_lanes)
        if not canonical:
            return self._legacy.run(batch_lanes, bp_start, max_snps,
                                    tsec_minus)
        if n > self.CHUNK:
            out = []
            for lo in range(0, n, self.CHUNK):
                hi = lo + self.CHUNK
                out.extend(self.run(batch_lanes[lo:hi], bp_start,
                                    max_snps[lo:hi], tsec_minus[lo:hi]))
            return out
        from pindel_tpu.profiling import g_timer
        t0 = time.monotonic()
        b = _b_bucket(n, self.B_BUCKETS)
        qlen = np.zeros(b, np.int32)
        qlen[:n] = [lanes[0].query.shape[0] for lanes in batch_lanes]
        qlen[n:] = 1
        lmax = _round_up(max(int(qlen.max()), 8), 128)
        codes = np.full((b, lmax), dna.N, np.int8)
        start = np.zeros(b, np.int64)
        end = np.zeros(b, np.int64)
        for i, lanes in enumerate(batch_lanes):
            q = lanes[0].query
            codes[i, :q.shape[0]] = q
            start[i] = lanes[0].start
            end[i] = lanes[0].end
        w = self._w_bucket(max(int((end - start).max()), 1))
        if w + lmax > SPACER:
            return self._legacy.run(batch_lanes, bp_start, max_snps,
                                    tsec_minus)
        ms = np.zeros(b, np.int32)
        ms[:n] = max_snps
        tm = np.zeros(b, np.int32)
        tm[:n] = tsec_minus
        thr = np.zeros(b, np.int32)
        thr[:n] = np.ceil(np.float32(
            qlen[:n].astype(np.float64) * np.float64(self.rate))
        ).astype(np.int32)
        meta = np.zeros((b, FW_WORDS), np.int32)
        meta[:, 0] = start
        meta[:, 1] = end
        meta[:, 2] = qlen
        meta[:, 3] = (ms | (tm.astype(np.int64) << 8)
                      | (thr.astype(np.int64) << 16))
        payload = _pack_payload(codes, meta)
        lsteps = _round_up(int(qlen[:n].max()), 16)
        t1 = time.monotonic()
        g_timer.add("fused: pack bdwin", t1 - t0)
        out_dev = self._far_win_call(
            self.chromcat_dev, jnp.asarray(payload), self.maxmm_dev,
            w=w, lmax=lmax, mpm=self.mpm, bp_start=bp_start,
            lsteps=lsteps)
        outarr = np.asarray(jax.device_get(out_dev))
        t2 = time.monotonic()
        g_timer.add(f"fused: bdwin wait w={w} b={b}", t2 - t1)
        nw = lmax // 32
        emit = unpack_words(outarr[:n, :nw], lmax)
        rep = outarr[:n, nw].astype(np.int64)
        flags = outarr[:n, nw + 1]
        any_emit = (flags & 1).astype(bool)
        uni = ((flags >> 1) & 1).astype(bool)
        lane = rep // w
        w_off = rep % w
        ss = np.where(lane == 1, end[:n] - (w + lmax), start[:n])
        q_dev = np.where((lane == 1)[:, None], dna.RC[codes[:n]],
                         codes[:n]).astype(np.int8)
        chains = decode_chains(self.chrom_codes, emit, w_off, ss,
                               lane == 1, q_dev, qlen[:n],
                               np.full(n, w, np.int64), lmax)
        from pindel_tpu.reads import AnchorSet
        from pindel_tpu.search import _anchorset_from_chain
        results: List = [None] * n
        legacy_rows: List[int] = []
        for i in range(n):
            ch = chains[i]
            if not any_emit[i] or ch is None:
                results[i] = (AnchorSet.empty(), 0)
            elif not uni[i]:
                # non-uniform chain: exact per-length reconstruction via
                # the legacy per-lane path
                legacy_rows.append(i)
            else:
                lm = bool(lane[i])
                results[i] = (_anchorset_from_chain(
                    ch, lm, lm, self.chrom_name), ch.full_mm)
        from pindel_tpu.profiling import g_fallback
        g_fallback.add(n, len(legacy_rows))
        if legacy_rows:
            sub = self._legacy.run(
                [batch_lanes[i] for i in legacy_rows], bp_start,
                [max_snps[i] for i in legacy_rows],
                [tsec_minus[i] for i in legacy_rows])
            for i, res in zip(legacy_rows, sub):
                results[i] = res
        g_timer.add("fused: decode bdwin", time.monotonic() - t2)
        return results

    # kernel dispatch points (overridden by the mesh backend)
    def _close_call(self, *args, **static):
        return _close_kernel_jit(*args, **static)

    def _far_call(self, *args, **static):
        return _far_kernel_jit(*args, **static)

    def _far_win_call(self, *args, **static):
        return _far_win_kernel_jit(*args, **static)

    @staticmethod
    def _w_bucket(width: int) -> int:
        """Window bucket: 128·2^k with 3·2^k intermediates (192, 384,
        768, 1536, ...) — the range-1 close window is 3x the library
        insert size, so power-of-two-only buckets waste up to 25% of the
        dominant scan (insert 500 -> window 1500 -> bucket 2048)."""
        b = 128
        while True:
            if width <= b:
                return b
            if width <= (b // 2) * 3:
                return (b // 2) * 3
            b *= 2

    def _budgets(self, qlen: np.ndarray, nb: int):
        ms = self.maxmm[np.minimum(qlen, MAX_READ_LENGTH - 1)].astype(
            np.int32)
        ms[nb:] = 0
        tm = ms + self.settings.additional_mismatch
        assert int(tm.max()) <= 200, "mismatch budget exceeds u8 headroom"
        # integer threshold equivalent to CheckMismatches' float compare
        # (searcher.cpp:383-387): float32(k) >= float32(n*rate), with k
        # integral and < 2^24, holds iff k >= ceil(float32(n*rate))
        ma = np.float32(qlen.astype(np.float64) * np.float64(self.rate))
        thr = np.ceil(ma).astype(np.int32)
        return ms, tm, thr

    @staticmethod
    def _pack_codes(reads, nb: int, b: int, lmax: int) -> np.ndarray:
        """[b, lmax] int8 base codes for a read chunk in one encode pass
        (the per-read slice-assignment loop was a profile hotspot)."""
        qlen = np.fromiter((len(r.seq) for r in reads), np.int64, nb)
        flat = dna.encode("".join(r.seq for r in reads))
        offs = np.zeros(nb, np.int64)
        np.cumsum(qlen[:-1], out=offs[1:])
        li = np.arange(lmax, dtype=np.int64)[None, :]
        valid = li < qlen[:, None]
        codes = np.full((b, lmax), dna.N, np.int8)
        codes[:nb][valid] = flat[(offs[:, None] + li)[valid]]
        return codes

    # ------------------------------------------------------------- close
    def close_ends(self, reads, bp_start: int):
        """Run the 4-attempt close-end schedule for all reads.

        Returns per read: (chain: Optional[ChainDecode], winner attempt
        0..3 or -1, needs_fallback: bool).

        Chunks are dispatched asynchronously up front (JAX dispatch does
        not block), then decoded in order — host pack/decode of chunk i
        overlaps device execution of chunk i+1.
        """
        return self.close_ends_decode(
            reads, self.close_ends_dispatch(reads, bp_start))

    # chunking: one launch covers up to CHUNK rows; a smaller leading
    # chunk starts the host decode stream early when the batch spills.
    CHUNK = 32768
    LEAD = 8192

    def _chunk_plan(self, n: int) -> List[Tuple[int, int]]:
        """(lo, hi) chunks: a small leading chunk whenever the batch
        exceeds it, so the host's decode stream (and the per-chunk far
        dispatch behind it) starts after the first small kernel instead
        of the first full-size one — this also overlaps the tail
        window's close decode with its remaining close chunk."""
        if n == 0:
            return []
        # a sub-512-row tail rides in the first chunk instead of a
        # launch of its own
        if n <= self.LEAD or n - self.LEAD < 512:
            return [(0, n)]
        plan = [(0, self.LEAD)]
        lo = self.LEAD
        while lo < n:
            plan.append((lo, min(lo + self.CHUNK, n)))
            lo += self.CHUNK
        return plan

    def close_ends_dispatch_lazy(self, batch, act, bp_start: int):
        """Batch-array dispatch over a lazy ReadBatch: ``act`` holds the
        batch row indices of the active reads (non-empty sequences), in
        window order."""
        n = act.size
        results = [(None, -1, False)] * n
        pending = []
        for lo, hi in self._chunk_plan(n):
            pending.append(self._close_dispatch_batch(
                batch, act[lo:hi], lo, results, bp_start))
        return results, pending

    def close_ends_dispatch(self, reads, bp_start: int):
        """Async half of close_ends: ONE launch per chunk evaluates the
        whole 4-attempt schedule (ranges merged on device with range-0
        precedence, GetCloseEnd's loop order pindel.cpp:2537-2576);
        returns a token for ``close_ends_decode``."""
        n = len(reads)
        results: List[Tuple[Optional[ChainDecode], int, bool]] = \
            [(None, -1, False)] * n
        pending = []
        for lo, hi in self._chunk_plan(n):
            pending.append(
                self._close_dispatch(reads[lo:hi], lo, results, bp_start))
        return results, pending

    def close_ends_decode(self, reads, token):
        results, pending = token
        for st in pending:
            self._close_finish(st, results)
        for st in pending:
            fut = st.pop("fut", None)
            if fut is not None:
                fut.result()
        return results

    def close_ends_decode_stream(self, reads, token):
        """Yield (lo, hi, results) per chunk as its device results land —
        callers can finalize and dispatch far-end kernels for early
        chunks while later close chunks still execute."""
        results, pending = token
        for st in pending:
            self._close_finish(st, results)
            fut = st.pop("fut", None)
            if fut is not None:
                fut.result()
            yield st["base"], st["base"] + st["nb"], results

    def _close_dispatch(self, reads, base: int, results, bp_start: int):
        nb = len(reads)
        b = _b_bucket(nb, self.B_BUCKETS)
        blob, offs = _seq_blob(reads, nb)
        qlen = np.zeros(b, np.int32)
        qlen[:nb] = np.diff(offs)
        minus = np.zeros(b, bool)
        pos = np.zeros(b, np.int64)
        isz = np.zeros(b, np.int64)
        for i, r in enumerate(reads):
            minus[i] = r.matched_d == "-"
            pos[i] = r.matched_rel_pos
            isz[i] = r.insert_size
        lmax = _round_up(max(int(qlen.max()), 8), 128)
        pack_fn = lambda meta: _native_pack_close(blob, offs, nb, b,  # noqa: E731
                                                  lmax, meta)
        codes_fn = lambda: _native_codes(blob, offs, nb, b, lmax)  # noqa: E731
        return self._close_dispatch_core(
            nb, b, lmax, qlen, minus, pos, isz, base, results, bp_start,
            pack_fn, codes_fn)

    def _close_dispatch_batch(self, batch, rows, base: int, results,
                              bp_start: int):
        """Array-sourced dispatch: a lazy ReadBatch + row indices (no
        SplitRead objects touched)."""
        nb = rows.size
        b = _b_bucket(nb, self.B_BUCKETS)
        qlen = np.zeros(b, np.int32)
        qlen[:nb] = batch.sl[rows]
        minus = np.zeros(b, bool)
        minus[:nb] = batch.dm[rows] != 0
        pos = np.zeros(b, np.int64)
        pos[:nb] = batch.pos[rows]
        isz = np.zeros(b, np.int64)
        isz[:nb] = batch.isz[rows]
        lmax = _round_up(max(int(qlen.max()), 8), 128)
        soff = np.ascontiguousarray(batch.so[rows])
        slen = np.ascontiguousarray(batch.sl[rows])
        blob = batch.blob
        pack_fn = lambda meta: _native_pack_close_at(  # noqa: E731
            blob, soff, slen, nb, b, lmax, meta)
        codes_fn = lambda: _native_codes_at(blob, soff, slen, nb, b,  # noqa: E731
                                            lmax)
        return self._close_dispatch_core(
            nb, b, lmax, qlen, minus, pos, isz, base, results, bp_start,
            pack_fn, codes_fn)

    def _close_dispatch_core(self, nb, b, lmax, qlen, minus, pos, isz,
                             base, results, bp_start, pack_fn, codes_fn):
        from pindel_tpu.genome import SPACER
        from pindel_tpu.profiling import g_timer
        t0 = time.monotonic()
        ms, tm, thr = self._budgets(qlen, nb)
        # attempt windows (close_end_lane geometry, pindel.cpp:2271-2316)
        win = np.zeros((2, b, 2), np.int64)
        for k in (0, 1):
            plus_start = pos + SPACER - k * isz
            plus_end = plus_start + (2 * k + 1) * isz
            minus_end = pos + SPACER + k * isz
            minus_start = minus_end - (2 * k + 1) * isz
            win[k, :, 0] = np.where(minus, minus_start, plus_start)
            win[k, :, 1] = np.where(minus, minus_end, plus_end)
        w0 = self._w_bucket(max(int((win[0, :, 1] - win[0, :, 0]).max()), 1))
        w1 = self._w_bucket(max(int((win[1, :, 1] - win[1, :, 0]).max()), 1))
        qlen[nb:] = 1                      # padding rows: never active
        st = dict(dev=None, base=base, nb=nb, b=b, qlen=qlen,
                  codes_fn=codes_fn, minus=minus, win=win, w0=w0,
                  w1=w1, lmax=lmax, bp_start=bp_start,
                  lsteps=_round_up(int(qlen[:nb].max()), 16))
        if w0 + lmax > SPACER:
            # huge mate-pair insert sizes make even the range-0 window
            # bucket outgrow the spacer padding the tile gather relies
            # on; route the whole chunk through the exact-semantics
            # fallback instead (ADVICE r2)
            for i in range(nb):
                results[base + i] = (None, -1, True)
            return st
        # range-1 windows can outgrow the spacer even when range 0 fits
        # (3x wider): skip range 1 on device, fall back per failure
        with_r1 = (w1 + lmax) <= SPACER
        st["with_r1"] = with_r1
        if int(isz.max()) > 0x1ffff or int(qlen.max()) > 0x3ff \
                or int(thr.max()) > 0x3ff:
            # bit-packed meta cannot hold this chunk (jumbo inserts);
            # exact-semantics fallback
            for i in range(nb):
                results[base + i] = (None, -1, True)
            return st
        meta = _close_meta(pos, isz, qlen, ms, tm, thr, minus)
        payload = pack_fn(meta)
        t1 = time.monotonic()
        g_timer.add("fused: pack close", t1 - t0)
        st["dev"] = self._close_call(
            self.chromcat_dev, jnp.asarray(payload), self.maxmm_dev,
            w0=w0, w1=w1, lmax=lmax, mpm=self.mpm, bp_start=bp_start,
            lsteps=st["lsteps"], with_r1=with_r1)
        _copy_to_host_async([st["dev"]])
        g_timer.add("fused: dispatch close", time.monotonic() - t1)
        return st

    def _close_finish(self, st, results):
        """Wait for a chunk's merged kernel output and decode winners of
        both ranges (the decode itself runs on the -T pool when enabled,
        overlapping the next chunk's device wait; the caller joins
        st["fut"] before consuming results)."""
        from pindel_tpu.profiling import g_timer
        if st["dev"] is None:
            return
        base, nb, lmax = st["base"], st["nb"], st["lmax"]
        t1 = time.monotonic()
        out = np.asarray(jax.device_get(st["dev"]))
        st["dev"] = None
        t2 = time.monotonic()
        g_timer.add(
            f"fused: close wait w={st['w0']}/{st['w1']} b={st['b']}",
            t2 - t1)
        nw = lmax // 32
        emit = unpack_words(out[:nb, :nw], lmax)
        rep = out[:nb, nw].astype(np.int64)
        flags = out[:nb, nw + 1]
        winner = (flags & 255).astype(np.int64)
        uniform = ((flags >> 8) & 1).astype(bool)
        if not st["with_r1"]:
            # range-1 window outgrew the spacer: exact-semantics
            # fallback for range-0 failures (reruns the whole schedule
            # from the original read on host)
            for i in np.flatnonzero(winner == 255).tolist():
                results[base + i] = (None, -1, True)

        def _decode():
            t3 = time.monotonic()
            codes = st["codes_fn"]()
            r0 = np.flatnonzero(winner < 2)
            if r0.size:
                self._decode_close_rows(
                    st, results, r0, emit[r0], rep[r0], winner[r0],
                    uniform[r0], st["qlen"], codes, st["minus"],
                    st["win"][0], st["w0"], flip=(winner[r0] == 1))
            r1 = np.flatnonzero((winner == 2) | (winner == 3))
            if r1.size:
                self._decode_close_rows(
                    st, results, r1, emit[r1], rep[r1], winner[r1],
                    uniform[r1], st["qlen"], codes, st["minus"],
                    st["win"][1], st["w1"], flip=(winner[r1] == 2))
            g_timer.add("fused: decode close", time.monotonic() - t3)

        pool = self._decode_pool()
        if pool is not None:
            st["fut"] = pool.submit(_decode)
        else:
            _decode()

    def _decode_close_rows(self, st, results, idx, emit, rep_w,
                           winner, uniform, qlen_a, codes_a, minus_a,
                           win_a, wbuck: int, *, flip):
        """Decode the winning attempts of a set of rows into results.

        ``idx``: chunk-relative read indices these rows map to; ``flip``:
        per-row 'query was the RC-flipped sequence' flags (attempts 1
        and 2 of the schedule); ``winner`` is in global attempt space
        (0..3), with ``win_a``/``wbuck`` the winning range's geometry.
        """
        base, lmax = st["base"], st["lmax"]
        rows = idx
        n = idx.size
        qlen = qlen_a[rows]
        codes = codes_a[rows]
        minus = minus_a[rows]
        start = win_a[rows, 0]
        end = win_a[rows, 1]
        tlen = wbuck + lmax
        ss = np.where(minus, end - tlen, start)
        # device-oriented query of the winning attempt, vectorized:
        # '-' reads use R(f) / C(f); '+' reads RC(f) / f
        # (see _close_kernel)
        cf = dna.RC[codes]
        li = np.arange(lmax)
        ridx = np.where(li < qlen[:, None],
                        np.maximum(qlen[:, None] - 1 - li, 0), li)
        rf = np.where(li < qlen[:, None],
                      np.take_along_axis(codes, ridx, axis=1), dna.N)
        rcf = np.where(li < qlen[:, None],
                       np.take_along_axis(cf, ridx, axis=1), dna.N)
        mcol = minus[:, None]
        fcol = np.asarray(flip)[:, None]
        q_dev = np.where(mcol, np.where(fcol, cf, rf),
                         np.where(fcol, codes, rcf)).astype(np.int8)
        chains = decode_chains(self.chrom_codes, emit, rep_w, ss,
                               minus, q_dev, qlen,
                               np.full(n, wbuck, np.int64), lmax)
        winl = winner.tolist()
        unil = uniform.tolist()
        idxl = idx.tolist()
        for k in range(n):
            ch = chains[k]
            if ch is None:
                continue
            if not unil[k]:
                results[base + idxl[k]] = (None, winl[k], True)
                continue
            results[base + idxl[k]] = (ch, winl[k], False)

    # --------------------------------------------------------------- far
    def far_ends(self, reads, spans: Sequence[int], comp_size: int,
                 bp_start: int = 10):
        """Geometric far-end escalation for already-close-mapped reads.

        spans are the per-round half-window spans (64*4^k).  Returns per
        read: (chain | None, lane_minus, replaced, needs_fallback).
        """
        return self.far_ends_decode(
            reads, self.far_ends_dispatch(reads, spans, comp_size,
                                          bp_start))

    def far_ends_dispatch(self, reads, spans: Sequence[int],
                          comp_size: int, bp_start: int = 10):
        """Async half of far_ends (token for ``far_ends_decode``)."""
        n = len(reads)
        results: List[Tuple[Optional[ChainDecode], bool, bool, bool]] = \
            [(None, False, False, False)] * n
        pending = []
        for lo, hi in self._chunk_plan(n):
            pending.append(self._far_dispatch(reads[lo:hi], lo, spans,
                                              comp_size, bp_start))
        return results, pending

    def far_ends_decode(self, reads, token):
        results, pending = token
        for st in pending:
            self._far_decode(st, results)
        return results

    def _far_dispatch(self, reads, base: int, spans, comp_size,
                      bp_start: int):
        from pindel_tpu.genome import SPACER
        from pindel_tpu.profiling import g_timer
        t0 = time.monotonic()
        nb = len(reads)
        b = _b_bucket(nb, self.B_BUCKETS)
        nr = len(spans)
        blob, offs = _seq_blob(reads, nb)
        qlen = np.zeros(b, np.int32)
        qlen[:nb] = np.diff(offs)
        lmax = _round_up(max(int(qlen.max()), 8), 128)
        close_max = np.zeros(b, np.int32)
        init_max = np.zeros(b, np.int32)
        center = np.zeros(b, np.int64)
        for i, r in enumerate(reads):
            close_max[i] = r.max_len_close()
            init_max[i] = r.max_len_far()
            center[i] = r.last_abs_loc_close_end()
        qlen[nb:] = 1                        # padding rows: never active
        close_max[nb:] = 1
        wins = np.zeros((b, nr, 2), np.int64)
        ws = []
        for k, span in enumerate(spans):
            # window geometry: search.py search_far_ends
            start = np.where(center > span + SPACER, center - span, SPACER)
            end = np.minimum(center + span, comp_size - SPACER)
            wins[:, k, 0] = start
            wins[:, k, 1] = np.maximum(end, start)
            ws.append(self._w_bucket(2 * span))
        assert max(ws) + lmax <= SPACER, (ws, lmax)
        ms, tm, thr = self._budgets(qlen, nb)
        assert int(qlen.max()) <= 0x3ff and int(close_max.max()) <= 0x3ff \
            and int(init_max.max()) <= 0x3ff and int(thr.max()) <= 0x3ff, \
            "read length exceeds far-meta bit packing"
        meta = _far_meta(center, qlen, close_max, init_max, ms, tm, thr,
                         comp_size)
        payload = _native_pack_far(blob, offs, nb, b, lmax, meta)

        t1 = time.monotonic()
        g_timer.add("fused: pack far", t1 - t0)
        dev = self._far_call(
            self.chromcat_dev, jnp.asarray(payload), self.maxmm_dev,
            spans=tuple(spans), ws=tuple(ws), lmax=lmax, mpm=self.mpm,
            bp_start=bp_start,
            lsteps=_round_up(int(qlen[:nb].max()), 16))
        _copy_to_host_async([dev])
        g_timer.add("fused: dispatch far", time.monotonic() - t1)
        return dict(dev=dev, base=base, nb=nb, b=b, qlen=qlen, blob=blob,
                    offs=offs, wins=wins, ws=ws, lmax=lmax)

    def _far_decode(self, st, results):
        from pindel_tpu.profiling import g_timer
        base, nb, lmax = st["base"], st["nb"], st["lmax"]
        qlen, wins, ws = st["qlen"], st["wins"], st["ws"]
        codes = _native_codes(st["blob"], st["offs"], nb, st["b"], lmax)
        t2 = time.monotonic()
        out = np.asarray(jax.device_get(st["dev"]))
        g_timer.add(f"fused: far wait ws={tuple(ws)} b={st['b']}",
                    time.monotonic() - t2)
        t2 = time.monotonic()

        nw = lmax // 32
        emit = unpack_words(out[:nb, :nw], lmax)
        rep = out[:nb, nw].astype(np.int64)
        flags = out[:nb, nw + 1]
        win_round = (flags & 255).astype(np.int64)
        replaced = ((flags >> 8) & 1).astype(bool)
        uni = ((flags >> 9) & 1).astype(bool)

        rr = np.where(win_round == 255, 0, win_round)
        wbuck = np.asarray(ws, np.int64)[rr]
        lane = rep // wbuck
        w_off = rep % wbuck
        start = wins[np.arange(nb), rr, 0]
        end = wins[np.arange(nb), rr, 1]
        tlen = wbuck + lmax
        ss = np.where(lane == 1, end - tlen, start)
        q_dev = np.where((lane == 1)[:, None], dna.RC[codes[:nb]],
                         codes[:nb]).astype(np.int8)
        chains = decode_chains(self.chrom_codes, emit, w_off, ss,
                               lane == 1, q_dev, qlen[:nb], wbuck, lmax)
        lanel = (lane == 1).tolist()
        unil = uni.tolist()
        for i in np.flatnonzero(replaced).tolist():
            ch = chains[i]
            if ch is not None and not unil[i]:
                results[base + i] = (None, False, True, True)
                continue
            results[base + i] = (ch, lanel[i], True, False)
        g_timer.add("fused: decode far", time.monotonic() - t2)
