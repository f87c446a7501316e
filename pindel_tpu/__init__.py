"""pindel_tpu — a structural-variant caller with the capabilities of Pindel,
running its search on an accelerator through JAX.

A from-scratch JAX/XLA/Pallas implementation of split-read SV discovery
(pattern-growth close-end / far-end anchor search, event geometry, clustering,
reporting, VCF conversion):

* the hot pattern-growth search (reference: ``searcher.cpp``,
  ``farend_searcher.cpp``, ``pindel.cpp:2250-2902``) is re-expressed as a dense
  wavefront DP over (candidate-position lanes x prefix length), batched over
  reads and executed on the device via XLA and, on NVIDIA GPUs, a Triton
  kernel written in Pallas;
* multi-device scaling shards read batches over a ``jax.sharding.Mesh``
  (data-parallel over lanes) instead of the reference's OpenMP loops;
* the host side (ingestion, event clustering, report/VCF emission) is
  Python/NumPy with a native C++ data plane for BAM decoding.

The reference implementation studied for behaviour (NOT copied) is
genome/pindel 0.2.5b9.
"""

__version__ = "0.1.0"

from pindel_tpu.config import Settings, max_mismatch_table
from pindel_tpu.genome import Genome, Chromosome, SPACER
from pindel_tpu.reads import SplitRead, read_pindel_file
