"""The Hopper scan kernel (ops/scan_triton.py) and the choice of kernel.

The kernel runs here in Pallas interpret mode and must match the XLA twin
(engine_fused._xla_scan_rows) bit for bit; on the card the same check
runs compiled in chip_smoke.py.
"""
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import jax
import jax.numpy as jnp

from pindel_tpu import dna
from pindel_tpu.ops import engine_fused as ef
from pindel_tpu.ops.scan_triton import BR, merge_tiles, triton_scan_rows


def _rows(seed, rows, w, lmax, lsteps, off_max):
    """Tiles with lane space WE = w + off_max, queries copied from the
    window with a few substitutions and N bases."""
    rng = np.random.default_rng(seed)
    t = w + lmax + off_max
    tiles = rng.integers(0, 5, (rows, t)).astype(np.int8)
    off = rng.integers(0, off_max + 1, rows).astype(np.int32)
    qlen = rng.integers(8, lsteps + 1, rows).astype(np.int32)
    qq = np.full((rows, lmax), dna.N, np.int8)
    for i in range(rows):
        s = int(off[i] + rng.integers(0, w))
        qq[i, :qlen[i]] = tiles[i, s:s + qlen[i]]
        for j in rng.integers(0, qlen[i], size=int(rng.integers(0, 4))):
            qq[i, j] = rng.integers(0, 5)
    valid_w = rng.integers(1, w + 1, rows).astype(np.int32)
    thr = rng.integers(1, 8, rows).astype(np.int32)
    return [jnp.asarray(a) for a in (tiles, qq, valid_w, qlen, thr, off)]


@pytest.mark.parametrize("seed,rows,w,lmax,lsteps,off_max", [
    (0, 16, 128, 128, 128, 0),        # aligned, one row block, full scan
    (1, 37, 192, 128, 112, 64),       # padding rows, unaligned off
    (2, 20, 512, 256, 160, 128),      # lmax 256, lsteps < lmax
    (3, 33, 768, 128, 48, 128),       # short reads
    (4, 9, 1536, 128, 112, 128),      # close range-1 bucket, 13 tiles
    (5, 18, 2048, 256, 256, 128),     # widest bucket, full 256 steps
])
def test_interpret_matches_xla_twin(seed, rows, w, lmax, lsteps, off_max):
    args = _rows(seed, rows, w, lmax, lsteps, off_max)
    static = dict(w=w, lmax=lmax, mpm=3, lsteps=lsteps)
    kx, k2x = ef._xla_scan_rows(*args, **static)
    kt, k2t = triton_scan_rows(*args, interpret=True, **static)
    assert kt.shape == (rows, lmax)
    np.testing.assert_array_equal(np.asarray(kx), np.asarray(kt))
    np.testing.assert_array_equal(np.asarray(k2x), np.asarray(k2t))
    # columns past lsteps stay zero, as the twin pads them
    assert not np.asarray(kt)[:, lsteps:].any()


def test_padding_rows_do_not_leak():
    """A row count that is no multiple of the row block gives the same
    rows as the same rows inside a longer batch."""
    rows = 3 * BR + 5
    args = _rows(7, rows, 256, 128, 112, 128)
    static = dict(w=256, lmax=128, mpm=3, lsteps=112)
    full = triton_scan_rows(*args, interpret=True, **static)
    head = triton_scan_rows(*[a[:BR + 1] for a in args], interpret=True,
                            **static)
    for f, h in zip(full, head):
        np.testing.assert_array_equal(np.asarray(f)[:BR + 1], np.asarray(h))


@settings(max_examples=60, deadline=None)
@given(st.lists(st.lists(st.integers(0, 12), min_size=4, max_size=4),
                min_size=1, max_size=6))
def test_tile_merge_equals_whole_window_min(tiles):
    """(kmin, k2) merged over tiles equals the whole window's min and the
    min over all keys != that min (MAXI when every key equals it), even
    when keys repeat across tiles."""
    keys = np.asarray(tiles, np.int32)                 # [NT, lanes]
    maxi = np.int32(2 ** 31 - 1)
    kmin_t = keys.min(axis=1)
    k2_t = np.where(keys == kmin_t[:, None], maxi, keys).min(axis=1)
    k, k2 = merge_tiles(jnp.asarray(kmin_t), jnp.asarray(k2_t))
    flat = keys.reshape(-1)
    assert int(k) == flat.min()
    rest = flat[flat != flat.min()]
    assert int(k2) == (rest.min() if rest.size else maxi)


def _lowered(platform):
    r, w, lmax, lsteps = 32, 1536, 128, 112
    t = ((w + lmax + 127) // 128 + 1) * 128
    shapes = (jax.ShapeDtypeStruct((r, t), jnp.int8),
              jax.ShapeDtypeStruct((r, lmax), jnp.int8),
              *[jax.ShapeDtypeStruct((r,), jnp.int32)] * 4)
    fn = jax.jit(lambda *a: ef._scan_rows(*a, w=w, lmax=lmax, mpm=3,
                                          lsteps=lsteps))
    return fn.trace(*shapes).lower(lowering_platforms=(platform,)).as_text()


def test_scan_rows_lowers_xla_twin_for_cpu():
    text = _lowered("cpu")
    assert "triton" not in text
    assert "stablehlo.while" in text


def test_scan_rows_lowers_triton_kernel_for_cuda():
    text = _lowered("cuda")
    assert "triton" in text
    assert "stablehlo.while" not in text


def test_scan_rows_on_cpu_device_is_the_twin():
    args = _rows(11, 24, 384, 128, 96, 128)
    static = dict(w=384, lmax=128, mpm=3, lsteps=96)
    got = jax.jit(ef._scan_rows, static_argnames=tuple(static))(
        *args, **static)
    want = ef._xla_scan_rows(*args, **static)
    for g, x in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(x))
