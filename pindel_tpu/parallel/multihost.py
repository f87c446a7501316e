"""Multi-host execution: windows sharded across processes.

The reference is strictly single-process (SURVEY §2.3: OpenMP loops only);
its only scale-out surface is the manual two-phase -S/-p flow.  This
replacement shards the expensive stage — close/far anchor
search, which is embarrassingly parallel over windows — across processes,
while one coordinator runs the cheap, stateful report stage strictly in
window order, so output files are byte-identical to a single-process run:

* window w is searched by process ``w % num_hosts`` (each process runs its
  own device mesh for the fused kernels);
* a worker ships each searched window's reads (with their close/far
  anchor sets) to the coordinator;
* the coordinator (rank 0, which also searches its own share) consumes
  windows in order and runs detection/clustering/reporting exactly as the
  single-process pipeline does — the sequential report state
  (event counters, chromosome mask, report_length, interchromosomal pool)
  never leaves one process.

On several machines the same structure runs under
``jax.distributed.initialize()`` with ``rank = jax.process_index()`` and
the spool backed by a shared filesystem (``--dist files``) or the
distributed runtime's key-value service (``--dist jax``).  On one machine
the harness runs as local subprocesses — ``run_files_multihost`` spawns
``num_hosts - 1`` workers and acts as the coordinator; the golden test
asserts 2-process output equals 1-process output byte-for-byte.

BAM input is supported: the RP->BD evidence that accumulates
sequentially across windows is replayed by *every* rank for *every*
window (the discordant-pair intake is cheap relative to search), so all
ranks hold the identical BD state when searching their own windows and
the coordinator's _RP report is the canonical, complete one.  The only
restriction is -S (report-only-close), which is itself the manual
two-phase checkpoint flow.
"""
from __future__ import annotations

import os
import pickle
import subprocess
import sys
import tempfile
import time
from typing import List, Optional


class WindowSpool:
    """File-based exchange of searched windows between processes.

    The payload is the packed anchor-table tensor dict
    (parallel/payload.py) written with ``np.savez`` — pure arrays, no
    pickled objects; ``np.load`` runs with ``allow_pickle=False``.  On a
    pod the same arrays are the broadcast payload of ``JaxDistSpool``."""

    TIMEOUT = 900.0

    def __init__(self, root: str, rank: int, num_hosts: int,
                 worker: bool):
        self.root = root
        self.rank = rank
        self.num_hosts = num_hosts
        self.worker = worker

    def mine(self, widx: int) -> bool:
        return widx % self.num_hosts == self.rank

    def _path(self, widx: int) -> str:
        return os.path.join(self.root, f"w{widx:06d}.npz")

    def dump(self, widx: int, kept: List, bd_delta=None,
             rp_text: str = "") -> None:
        import numpy as np

        from pindel_tpu.parallel import payload
        path = self._path(widx)
        tmp = path + f".tmp{self.rank}"
        with open(tmp, "wb") as fh:
            np.savez(fh, **payload.pack(kept, bd_delta, rp_text))
        os.replace(tmp, path)

    def load(self, widx: int):
        """-> (reads, bd event delta, _RP text) for a worker window."""
        import numpy as np

        from pindel_tpu.parallel import payload
        path = self._path(widx)
        deadline = time.monotonic() + self.TIMEOUT
        while not os.path.exists(path):
            if time.monotonic() > deadline:
                raise TimeoutError(f"window {widx} never arrived from "
                                   f"worker {widx % self.num_hosts}")
            time.sleep(0.02)
        with np.load(path, allow_pickle=False) as z:
            d = {k: z[k] for k in z.files}
        return payload.unpack(d), *payload.unpack_bd(d)


def _build_pipeline(cfg):
    from pindel_tpu.genome import Genome
    from pindel_tpu.pipeline import Pipeline, make_backend_factory
    settings = cfg["settings"]
    genome = Genome.from_fasta(settings.reference_filename)
    factory = make_backend_factory(cfg["backend"], settings)
    pipe = Pipeline(settings, genome, backend_factory=factory)
    pipe.create_output_files()
    if settings.bam_config_filename:
        pipe.load_bam_config(settings.bam_config_filename)
    elif settings.pindel_config_filename:
        pipe.load_pindel_config(settings.pindel_config_filename)
    else:
        pipe.load_pindel_input(settings.pindel_filename)
    return pipe


def worker_main(cfg_path: str) -> int:
    if os.environ.get("PINDEL_TPU_WORKER_TRACE"):
        import faulthandler
        faulthandler.dump_traceback_later(
            int(os.environ["PINDEL_TPU_WORKER_TRACE"]), exit=True)
    with open(cfg_path, "rb") as fh:
        cfg = pickle.load(fh)
    if cfg.get("cpus"):
        os.sched_setaffinity(0, cfg["cpus"])
    if cfg.get("dist") == "jax":
        from pindel_tpu.parallel.distspool import (JaxDistSpool,
                                                   init_distributed)
        init_distributed(cfg["coordinator"], cfg["num_hosts"], cfg["rank"])
        spool = JaxDistSpool(cfg["rank"], cfg["num_hosts"])
    else:
        spool = WindowSpool(cfg["spool"], cfg["rank"], cfg["num_hosts"],
                            worker=True)
    pipe = _build_pipeline(cfg)
    pipe.spool = spool
    try:
        pipe.run()
    finally:
        pipe.close()
    return 0


DEVICE_BACKENDS = ("jax", "fused", "mesh")


def refuse_shared_gpu(backend: str, num_hosts: int) -> None:
    """Every --hosts process is a JAX process on this machine.  On a GPU
    each one reserves most of the card's memory when it starts, so the
    second would fail: one process drives the cards instead."""
    if num_hosts > 1 and backend in DEVICE_BACKENDS:
        import jax
        if jax.default_backend() == "gpu":
            raise SystemExit(
                f"--hosts {num_hosts} with --backend {backend} would start "
                f"{num_hosts} JAX processes on this machine's GPU, each "
                "reserving most of its memory; run one process with "
                "--backend mesh to use every card of the machine")


def run_files_multihost(reference_fa: str, pindel_file: Optional[str],
                        output_prefix: str, settings, backend: str,
                        num_hosts: int,
                        pindel_config: Optional[str] = None,
                        bam_config: Optional[str] = None,
                        dist: str = "files"):
    """Coordinator entry: spawn workers, search rank-0's windows locally,
    report everything in window order.  Same signature spirit as
    pipeline.run_files.

    BAM input works because every rank replays the sequential RP->BD
    evidence accumulation for every window (the intake is cheap relative
    to search); only the owning rank searches a window, and only the
    coordinator writes reports (incl. the canonical _RP)."""
    import copy

    from pindel_tpu.pipeline import run_files
    assert num_hosts >= 1
    if num_hosts == 1:
        return run_files(reference_fa, pindel_file, output_prefix,
                         settings=settings, backend=backend,
                         pindel_config=pindel_config,
                         bam_config=bam_config)
    s = copy.deepcopy(settings)
    s.reference_filename = reference_fa
    s.pindel_filename = pindel_file or ""
    s.pindel_config_filename = pindel_config or ""
    s.bam_config_filename = bam_config or ""
    assert not s.report_only_close_mapped_reads, \
        "-S is single-process (it is itself the two-phase checkpoint)"
    refuse_shared_gpu(backend, num_hosts)

    # workers inherit this environment, JAX_PLATFORMS included
    spool_dir = tempfile.mkdtemp(prefix="pindel_spool_")
    coordinator = ""
    if dist == "jax":
        import socket
        sock = socket.socket()
        sock.bind(("127.0.0.1", 0))
        coordinator = f"127.0.0.1:{sock.getsockname()[1]}"
        sock.close()
    # PINDEL_TPU_CPU_SHARD=1: give each simulated host a disjoint CPU
    # set (the honest local analog of per-host chips — otherwise one
    # XLA-CPU process already saturates the machine and sharded search
    # shows no speedup; used by tools/multihost_bench.py)
    cpu_shards = None
    if os.environ.get("PINDEL_TPU_CPU_SHARD"):
        cpus = sorted(os.sched_getaffinity(0))
        per = max(len(cpus) // num_hosts, 1)
        if num_hosts <= len(cpus):
            cpu_shards = [cpus[r * per:(r + 1) * per]
                          for r in range(num_hosts)]
        else:
            # more simulated hosts than cores: round-robin (hosts share
            # cores; measured efficiency then understates a real pod)
            cpu_shards = [[cpus[r % len(cpus)]] for r in range(num_hosts)]
        os.sched_setaffinity(0, cpu_shards[0])
    procs = []
    for rank in range(1, num_hosts):
        ws = copy.deepcopy(s)
        ws.output_prefix = os.path.join(spool_dir, f"worker{rank}_out")
        cfg = dict(settings=ws, backend=backend, spool=spool_dir,
                   rank=rank, num_hosts=num_hosts, dist=dist,
                   coordinator=coordinator,
                   cpus=cpu_shards[rank] if cpu_shards else None)
        cfg_path = os.path.join(spool_dir, f"cfg{rank}.pkl")
        with open(cfg_path, "wb") as fh:
            pickle.dump(cfg, fh, protocol=pickle.HIGHEST_PROTOCOL)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "pindel_tpu.parallel.multihost",
             cfg_path]))

    s.output_prefix = output_prefix
    if dist == "jax":
        from pindel_tpu.parallel.distspool import (JaxDistSpool,
                                                   init_distributed)
        init_distributed(coordinator, num_hosts, 0)
        spool = JaxDistSpool(0, num_hosts)
    else:
        spool = WindowSpool(spool_dir, 0, num_hosts, worker=False)
    try:
        run_files(reference_fa, pindel_file, output_prefix, settings=s,
                  backend=backend, pindel_config=pindel_config,
                  bam_config=bam_config, spool=spool)
    finally:
        if dist == "jax":
            # release the distributed barrier before waiting on workers:
            # their interpreter-exit shutdown blocks until every process
            # (including this coordinator) has shut down its client
            import jax
            jax.distributed.shutdown()
        for p in procs:
            p.wait(timeout=120)
    return s


if __name__ == "__main__":
    sys.exit(worker_main(sys.argv[1]))
