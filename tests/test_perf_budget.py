"""Host-layer budget (reference test/SmallTest/execution_time.sh,
Makefile:54-61: acceptance configs must finish under a wall-time budget).

The host layers (intake, decode, detectors, reporters) on a fixed CPU
scene must stay under a generous wall budget — it catches algorithmic
regressions (accidental O(reads x windows) rescans, per-read python
loops creeping back) on any machine.  The first run warms the XLA
compile cache and is not budgeted.
"""
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

from make_fai import make_fai  # noqa: E402

# generous: ~100x the measured warm wall (0.12 s for 760 reads) so CI /
# shared-host noise never trips it (the box swings +/-20% and has stalled
# for minutes at a time) while a 100x algorithmic
# regression (the class this guards against: accidental O(reads x
# windows) rescans, per-read python loops) still fails loudly
HOST_BUDGET_SECONDS = 12.0


def test_host_layers_within_budget(tmp_path):
    from pindel_tpu.config import Settings
    from pindel_tpu.pipeline import run_files
    from pindel_tpu.testing.simulate import standard_scene, write_fasta
    d = str(tmp_path)
    # small insert keeps the window buckets CPU-sized (w1 = 1024)
    ref, events, reads = standard_scene(
        seed=5, chrom_len=150_000, kinds=["DEL", "SI", "DI", "INV", "TD"] * 4,
        reads_per_event=12, n_noise=1200, chrom="chrP", insert_size=200)
    fa = os.path.join(d, "ref.fa")
    write_fasta(fa, [("chrP", ref)])
    make_fai(fa)
    txt = os.path.join(d, "reads.txt")
    reads.write(txt)
    n_reads = len(reads.names)

    s = Settings()
    s.analyze_li = True
    s.report_close_mapped_reads = True
    run_files(fa, txt, os.path.join(d, "warm"), settings=s,
              backend="fused")            # compile warmup, not budgeted
    t0 = time.time()
    run_files(fa, txt, os.path.join(d, "timed"), settings=s,
              backend="fused")
    wall = time.time() - t0
    assert open(os.path.join(d, "timed_D")).read()     # scene nonempty
    assert wall < HOST_BUDGET_SECONDS, (
        f"host layers took {wall:.2f}s for {n_reads} reads — over the "
        f"{HOST_BUDGET_SECONDS}s budget (see tests/test_perf_budget.py)")

