"""jax.distributed window transport: point-to-point anchor-table sends.

The pod-shaped data plane behind ``--hosts N --dist jax``: every process
runs the same window loop (``parallel/multihost.py`` ownership rule
``window % N == rank``); a worker-owned window's packed anchor tables
(parallel/payload.py) move to the coordinator as a worker->coordinator
SEND over the ``jax.distributed`` runtime's key-value service — a fixed
int64 length header plus one concatenated uint8 blob per window.  Only
the producing worker and the consuming coordinator touch a window's
payload; other ranks neither join a collective nor receive the bytes
(round 4 used ``broadcast_one_to_all``, which shipped every worker
window to ALL ranks — O(N * payload) and a forced global join).

The coordinator deletes each window's keys after consuming them, so the
in-flight footprint is bounded by how far workers run ahead (one to two
windows under the pipeline's 1-deep prefetch), not by the genome.

On this machine the plane is smoke-tested with N CPU processes
coordinated through ``jax.distributed.initialize`` (gRPC transport;
same wiring, same call order, no pod required).  On a real pod the same
calls ride the coordinator service over DCN; payloads are compact
anchor tables (tens of bytes per read), not read batches.

The payload blob layout is derived from ``payload.pack``'s key order
(deterministic dict order) — receivers reconstruct dtypes/shapes from
the header alone, so ragged windows need no pre-negotiated shapes.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from pindel_tpu.parallel import payload

# fixed schema: (key, dtype) in wire order.  Arrays are 1-D.
_SCHEMA = None


def _schema():
    global _SCHEMA
    if _SCHEMA is None:
        probe = payload.pack([])
        _SCHEMA = [(k, v.dtype) for k, v in probe.items()]
    return _SCHEMA


def _encode(arrs: Dict[str, np.ndarray]):
    schema = _schema()
    assert list(arrs.keys()) == [k for k, _ in schema], "schema drift"
    parts = [np.ascontiguousarray(arrs[k]).view(np.uint8).reshape(-1)
             for k, _ in schema]
    header = np.array([p.size for p in parts], np.int64)
    blob = np.concatenate(parts) if parts else np.zeros(0, np.uint8)
    return header, blob


def _decode(header: np.ndarray, blob: np.ndarray) -> Dict[str, np.ndarray]:
    schema = _schema()
    out: Dict[str, np.ndarray] = {}
    off = 0
    for (k, dt), nbytes in zip(schema, header.tolist()):
        raw = blob[off:off + int(nbytes)]
        out[k] = np.frombuffer(raw.tobytes(), dtype=dt)
        off += int(nbytes)
    return out


class JaxDistSpool:
    """Window spool over the jax.distributed key-value service.

    Implements the same interface Pipeline consumes (``mine``/``worker``/
    ``dump``/``load``).  ``needs_transport`` is always False: transport
    is point-to-point, so ranks that neither own nor report a window do
    nothing for it.
    """

    TIMEOUT_MS = 900_000

    def __init__(self, rank: int, num_hosts: int):
        self.rank = rank
        self.num_hosts = num_hosts
        self.worker = rank != 0

    # ownership --------------------------------------------------------
    def mine(self, widx: int) -> bool:
        return widx % self.num_hosts == self.rank

    def owner(self, widx: int) -> int:
        return widx % self.num_hosts

    def needs_transport(self, widx: int) -> bool:
        return False            # point-to-point: no global join needed

    # transport --------------------------------------------------------
    @staticmethod
    def _client():
        from jax._src import distributed
        client = distributed.global_state.client
        assert client is not None, "jax.distributed is not initialized"
        return client

    def dump(self, widx: int, kept: List, bd_delta=None,
             rp_text: str = "") -> None:
        """Owner side: send this window's searched reads (plus its
        RP->BD evidence delta + _RP text) to the coordinator."""
        header, blob = _encode(payload.pack(kept, bd_delta, rp_text))
        c = self._client()
        c.key_value_set_bytes(f"pindel/w{widx}/h", header.tobytes())
        c.key_value_set_bytes(f"pindel/w{widx}/b", blob.tobytes())

    def load(self, widx: int):
        """Coordinator side for a worker-owned window: blocking receive
        -> (reads, bd delta, _RP text); keys deleted afterwards so
        in-flight memory stays bounded."""
        c = self._client()
        h = c.blocking_key_value_get_bytes(f"pindel/w{widx}/h",
                                           self.TIMEOUT_MS)
        b = c.blocking_key_value_get_bytes(f"pindel/w{widx}/b",
                                           self.TIMEOUT_MS)
        for suffix in ("h", "b"):
            try:
                c.key_value_delete(f"pindel/w{widx}/{suffix}")
            except Exception:
                pass
        header = np.frombuffer(h, np.int64)
        blob = np.frombuffer(b, np.uint8)
        d = _decode(header, blob)
        return payload.unpack(d), *payload.unpack_bd(d)


def init_distributed(coordinator: str, num_processes: int,
                     process_id: int) -> None:
    """Initialize the jax.distributed runtime for one process (before
    any backend use; ``JAX_PLATFORMS`` picks the platform)."""
    import jax
    jax.distributed.initialize(coordinator_address=coordinator,
                               num_processes=num_processes,
                               process_id=process_id)
