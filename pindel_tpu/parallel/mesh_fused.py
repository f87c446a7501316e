"""Multi-device fused search: the production mesh backend.

Shards the fused engine (ops/engine_fused.py) data-parallel over the
``dp`` axis of a ``jax.sharding.Mesh``: each device owns a slice of the
read batch, the (padded) chromosome is replicated, and the per-read
search needs no collectives — the reduction points of the pipeline
(SURVEY.md §2.3: event clustering, support tallies, interchromosomal
pools) all live on the host after the compact per-read chain download.

The reference's parallel precedent is the OpenMP loop over reads in
ReadBuffer::flush (read_buffer.cpp:39-101) and SearchFarEnds
(pindel.cpp:1115-1121); here the "threads" are devices.  The dp×wp
window-sharded kernel with psum/pmin collectives lives in
parallel/mesh.py and remains the scaling path for few-reads × huge-
window workloads; data-parallel is the right layout for throughput
(reads are abundant, and one device holds a whole window's search).

The per-device body lowers the scan for the mesh's platform (see
engine_fused._scan_rows): the Triton kernel on CUDA devices, the XLA
scan on a CPU test mesh (xla_force_host_platform_device_count), with
identical results.
"""
from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import numpy as np

from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from pindel_tpu.ops import engine_fused as ef


def make_dp_mesh(n_devices: Optional[int] = None) -> Mesh:
    devs = jax.devices()
    n = n_devices or len(devs)
    return Mesh(np.array(devs[:n]), ("dp",))


def _shard(body, mesh, in_specs, out_specs):
    return shard_map(body, mesh=mesh, in_specs=in_specs,
                     out_specs=out_specs, check_vma=False)


class MeshFusedBackend(ef.FusedJaxBackend):
    """FusedJaxBackend whose kernels run shard_map'd over a dp mesh."""

    def __init__(self, settings, maxmm, chrom_codes, mesh: Mesh,
                 chrom_name: str = None):
        super().__init__(settings, maxmm, chrom_codes,
                         chrom_name=chrom_name)
        self.mesh = mesh
        self.dp = mesh.shape["dp"]
        assert all(b % self.dp == 0 for b in self.B_BUCKETS), (
            "batch buckets must divide the dp axis")
        self._close_cache = {}
        self._far_cache = {}
        self._far_win_cache = {}

    # the FusedJaxBackend chunk methods call these module-level jitted
    # kernels through self — override with shard_map'd equivalents.
    # Kernel IO is (chrom, payload, maxmm) -> one packed array:
    # chrom/maxmm replicated, payload rows sharded over dp.
    def _close_call(self, *args, **static):
        key = tuple(sorted(static.items()))
        fn = self._close_cache.get(key)
        if fn is None:
            body = partial(ef._close_kernel, **static)
            rep = P()          # chrom, maxmm: replicated
            dp = P("dp")
            fn = jax.jit(_shard(body, self.mesh,
                                (rep, dp, rep), dp))
            self._close_cache[key] = fn
        return fn(*args)

    def _far_call(self, *args, **static):
        key = tuple(sorted(static.items()))
        fn = self._far_cache.get(key)
        if fn is None:
            body = partial(ef._far_kernel, **static)
            rep = P()
            dp = P("dp")
            fn = jax.jit(_shard(body, self.mesh,
                                (rep, dp, rep), dp))
            self._far_cache[key] = fn
        return fn(*args)

    def _far_win_call(self, *args, **static):
        key = tuple(sorted(static.items()))
        fn = self._far_win_cache.get(key)
        if fn is None:
            body = partial(ef._far_win_kernel, **static)
            rep = P()
            dp = P("dp")
            fn = jax.jit(_shard(body, self.mesh,
                                (rep, dp, rep), dp))
            self._far_win_cache[key] = fn
        return fn(*args)
