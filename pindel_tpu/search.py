"""Close-end / far-end search drivers.

Round-based reformulation of the reference's per-read control flow so that
each round is one batched device kernel launch over all still-active reads:

* close end (reference GetCloseEnd, pindel.cpp:2531-2576): up to four
  attempts per read — (range 0, seq), (range 0, RC), (range 1, RC), (range 1,
  seq) — stopping at the first attempt that yields unique points.  The RC flip
  persists in the read (reference setUnmatchedSeq call at pindel.cpp:2545).
* far end (reference SearchFarEnd, pindel.cpp:1001-1074): BreakDancer/RP
  window clusters first, then geometrically growing windows (span 64*4^k)
  around the last close-end anchor, stopping when close+far cover the read.

Backends implement ``run(batch_lanes, bp_start, max_snps, tsec_minus)`` and
return per-read (unique points, whole-read mismatch count of the last point):
the NumPy oracle (exact-semantics CPU reference) or the batched JAX
engines (ops/engine_jax.py, ops/engine_fused.py).
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from pindel_tpu import dna
from pindel_tpu.config import Settings
from pindel_tpu.genome import SPACER, Chromosome
from pindel_tpu.ops import search_np
from pindel_tpu.ops.search_np import Lane
from pindel_tpu.reads import (ANTISENSE, BACKWARD, FORWARD, MINUS, PLUS,
                              SENSE, AnchorSet, SplitRead, UniquePoint,
                              clean_unique_points)


class NumpyBackend:
    """Exact-semantics CPU backend (pindel_tpu.ops.search_np)."""

    def __init__(self, settings: Settings, maxmm: np.ndarray):
        self.settings = settings
        self.maxmm = maxmm

    def run(self, batch_lanes: List[List[Lane]], bp_start: int,
            max_snps: Sequence[int], tsec_minus: Sequence[int]
            ) -> List[Tuple[List[UniquePoint], int]]:
        s = self.settings
        out = []
        for lanes, max_snp, tm in zip(batch_lanes, max_snps, tsec_minus):
            n = int(lanes[0].query.shape[0])
            stats = search_np.merged_stats(lanes, tm,
                                           s.min_perfect_match_around_bp)
            ups, full_mm = search_np.emit_unique_points(
                stats, lanes, bp_start=bp_start, bp_end=n - 1,
                max_snp_error=max_snp,
                additional_mismatch=s.additional_mismatch,
                max_mismatch=self.maxmm,
                mpm=s.min_perfect_match_around_bp,
                mismatch_rate=s.max_allowed_mismatch_rate)
            out.append((AnchorSet.from_points(ups), full_mm))
        return out


def close_end_lane(chrom: Chromosome, read: SplitRead,
                   range_index: int) -> Lane:
    """Seed window + lane for one close-end attempt.

    Reference: GetCloseEndInner, pindel.cpp:2271-2316.
    """
    if read.matched_d == PLUS:
        q = dna.revcomp(read.seq_codes())
        start = read.matched_rel_pos + SPACER - range_index * read.insert_size
        end = start + (2 * range_index + 1) * read.insert_size
        return Lane(chrom.seq, q, start, end, forward=True,
                    direction=FORWARD, strand=ANTISENSE, chr_name=chrom.name)
    else:
        q = read.seq_codes()
        end = read.matched_rel_pos + SPACER + range_index * read.insert_size
        start = end - (2 * range_index + 1) * read.insert_size
        return Lane(chrom.seq, q, start, end, forward=False,
                    direction=BACKWARD, strand=SENSE, chr_name=chrom.name)


def far_end_lanes(read: SplitRead,
                  regions: Sequence[Tuple[Chromosome, int, int]]
                  ) -> List[Lane]:
    """Both-strand lanes over far-end candidate regions (each region may
    live on a different chromosome — BreakDancer/RP windows can cross
    chromosomes).

    Reference: SearchFarEndAtPos, farend_searcher.cpp:46-103.  The minus
    strand (PD_Minus) is a backward lane over the reverse complement.
    """
    q = read.seq_codes()
    qrc = dna.revcomp(q)
    lanes: List[Lane] = []
    for (chrom, start, end) in regions:
        if start < 0:
            start = end - 1
        lanes.append(Lane(chrom.seq, q, start, end, forward=True,
                          direction=FORWARD, strand=SENSE,
                          chr_name=chrom.name))
        lanes.append(Lane(chrom.seq, qrc, start, end, forward=False,
                          direction=BACKWARD, strand=ANTISENSE,
                          chr_name=chrom.name))
    return lanes


_POOL_N = 512
_TRUE_POOL = np.ones(_POOL_N, dtype=bool)
_FALSE_POOL = np.zeros(_POOL_N, dtype=bool)
_ZERO8_POOL = np.zeros(_POOL_N, dtype=np.int8)
for _p in (_TRUE_POOL, _FALSE_POOL, _ZERO8_POOL):
    _p.flags.writeable = False


def _const_bool(value: bool, n: int) -> np.ndarray:
    pool = _TRUE_POOL if value else _FALSE_POOL
    if n <= _POOL_N:
        return pool[:n]
    return np.full(n, value, dtype=bool)


def _anchorset_from_chain(chain, dir_minus: bool, strand_minus: bool,
                          chr_name: str) -> AnchorSet:
    """AnchorSet from a fused-engine ChainDecode (single-lane chain).

    Constant columns are read-only slices of shared pools (broadcast_to
    per read showed up as ~15% of host time in profiles)."""
    n = chain.lengths.shape[0]
    zero8 = _ZERO8_POOL[:n] if n <= _POOL_N else np.zeros(n, np.int8)
    a = AnchorSet(chain.lengths, chain.abs_loc,
                  chain.mm,     # int32 counts; consumers upcast as needed
                  _const_bool(dir_minus, n),
                  _const_bool(strand_minus, n),
                  [chr_name], zero8)
    a.uniform = True
    return a


class Searcher:
    """Runs close- and far-end search over batches of reads."""

    def __init__(self, settings: Settings, backend=None):
        self.settings = settings
        self.maxmm = settings.max_mismatch()
        self.backend = backend or NumpyBackend(settings, self.maxmm)
        self._fallback = None       # NumPy backend for cross-chrom lanes

    def budget(self, read: SplitRead) -> Tuple[int, int]:
        """(MAX_SNP_ERROR, TOTAL_SNP_ERROR_CHECKED_Minus) per read.

        Reference: SPLIT_READ::setUnmatchedSeq, pindel.cpp:161-168.
        """
        max_snp = int(self.maxmm[read.read_length])
        return max_snp, max_snp + self.settings.additional_mismatch

    # ------------------------------------------------------------------ close
    def map_close_ends(self, chrom: Chromosome,
                       reads: Sequence[SplitRead]) -> None:
        """Fill read.up_close, flipping orientation as the reference does."""
        self.map_close_ends_finish(self.map_close_ends_async(chrom, reads))

    def map_close_ends_async(self, chrom: Chromosome,
                             reads: Sequence[SplitRead]):
        """Dispatch the device work for close-end mapping without blocking
        (fused backends); returns a token for ``map_close_ends_finish``.
        The pipeline uses this to overlap window N+1's close kernels with
        window N's host-side detection/reporting.

        A lazy ReadBatch (streaming text intake) dispatches straight from
        its field arrays — SplitRead objects materialize later, only for
        reads that actually mapped a close end."""
        if not hasattr(self.backend, "close_ends_dispatch"):
            return (chrom, reads, None, None)
        s = self.settings
        from pindel_tpu.textindex import ReadBatch
        if isinstance(reads, ReadBatch) and hasattr(
                self.backend, "close_ends_dispatch_lazy"):
            act = np.flatnonzero(reads.sl > 0)
            pending = self.backend.close_ends_dispatch_lazy(
                reads, act, s.min_close)
            return (chrom, reads, ("batch", reads, act), pending)
        active = [r for r in reads if len(r.seq) > 0]
        for r in active:
            r.max_snp_error = int(self.maxmm[len(r.seq)])
        pending = self.backend.close_ends_dispatch(active, s.min_close)
        return (chrom, reads, active, pending)

    def close_far_stream(self, chrom: Chromosome, close_token,
                         bd_regions=None):
        """Streamed pipeline step: as each close-end chunk's device
        results land, finalize its reads and immediately dispatch their
        far-end kernels — far execution overlaps the remaining close
        chunks.  With ``bd_regions`` the chunk's BreakDancer-window
        rounds run first (they gate the geometric escalation set, as in
        SearchFarEnd pindel.cpp:1001-1074), riding the same device queue
        as the still-executing close chunks.  Returns (kept reads in
        order, list of far tokens)."""
        chrom_, reads, active, tok = close_token
        if tok is None or not hasattr(self.backend,
                                      "close_ends_decode_stream"):
            self.map_close_ends_finish(close_token)
            kept = self.finalize_close_ends(reads)
            if not kept or self.settings.report_only_close_mapped_reads:
                return kept, []
            return kept, [self.search_far_ends_async(chrom, kept,
                                                     bd_regions)]
        kept_all: List[SplitRead] = []
        far_tokens = []
        only_close = self.settings.report_only_close_mapped_reads
        batch_mode = isinstance(active, tuple) and active \
            and active[0] == "batch"
        for lo, hi, results in self.backend.close_ends_decode_stream(
                active, tok):
            if batch_mode:
                _, batch, act = active
                sub = self._consume_close_batch(chrom, batch,
                                                act[lo:hi],
                                                results[lo:hi])
            else:
                sub = active[lo:hi]
                self._consume_close_results(chrom, sub, results[lo:hi])
            kept = self.finalize_close_ends(sub)
            kept_all.extend(kept)
            if kept and not only_close:
                far_tokens.append(self.search_far_ends_async(chrom, kept,
                                                             bd_regions))
        return kept_all, far_tokens

    def map_close_ends_finish(self, token) -> None:
        chrom, reads, active, pending = token
        if pending is None:
            if hasattr(self.backend, "close_ends"):
                self._map_close_fused(chrom, reads)
            else:
                self._map_close_rounds(chrom, reads, self.backend)
            return
        if isinstance(active, tuple) and active and active[0] == "batch":
            _, batch, act = active
            results = self.backend.close_ends_decode(None, pending)
            self._consume_close_batch(chrom, batch, act, results)
            return
        results = self.backend.close_ends_decode(active, pending)
        self._consume_close_results(chrom, active, results)

    def _consume_close_batch(self, chrom: Chromosome, batch, rows,
                             results) -> List[SplitRead]:
        """Batch twin of ``_consume_close_results``: materialize ONLY
        reads with a decoded chain or a pending fallback; returns the
        materialized reads in window order (callers finalize them)."""
        import time

        from pindel_tpu.profiling import g_fallback, g_timer
        t0 = time.monotonic()
        out: List[SplitRead] = []
        fallback: List[SplitRead] = []
        maxmm = self.maxmm
        rl = rows.tolist()
        for j, (chain, winner, needs_fb) in enumerate(results):
            if chain is None and not needs_fb:
                continue
            r = batch.materialize(rl[j])
            r.max_snp_error = int(maxmm[len(r.seq)])
            out.append(r)
            if needs_fb:
                fallback.append(r)   # rerun full schedule from original
                continue
            if winner in (1, 2):     # persistent setUnmatchedSeq flip
                r.seq = dna.flip_rc(r.seq)
            dm = r.matched_d == MINUS
            r.up_close = _anchorset_from_chain(chain, dm, not dm,
                                               chrom.name)
            r.used = False
            r.close_end_mismatch = chain.full_mm
        g_timer.add("search: consume close", time.monotonic() - t0)
        g_fallback.add(len(results), len(fallback))
        if fallback:
            self._map_close_rounds(chrom, fallback, self._oracle())
        return out

    def _map_close_fused(self, chrom: Chromosome,
                         reads: Sequence[SplitRead]) -> None:
        """Fused path: all four attempts in one device launch
        (ops/engine_fused.py); non-uniform chains rerun on the oracle."""
        s = self.settings
        active = [r for r in reads if r.read_length > 0]
        for r in active:
            r.max_snp_error = int(self.maxmm[r.read_length])
        results = self.backend.close_ends(active, s.min_close)
        self._consume_close_results(chrom, active, results)

    def _consume_close_results(self, chrom: Chromosome, active, results):
        import time

        from pindel_tpu.profiling import g_timer
        t0 = time.monotonic()
        fallback: List[SplitRead] = []
        for r, (chain, winner, needs_fb) in zip(active, results):
            if needs_fb:
                fallback.append(r)       # rerun full schedule from original
                continue
            if winner in (1, 2):         # persistent setUnmatchedSeq flip
                r.seq = dna.flip_rc(r.seq)
            if chain is not None:
                dm = r.matched_d == MINUS
                r.up_close = _anchorset_from_chain(chain, dm, not dm,
                                                   chrom.name)
                r.used = False
                r.close_end_mismatch = chain.full_mm
        g_timer.add("search: consume close", time.monotonic() - t0)
        from pindel_tpu.profiling import g_fallback
        g_fallback.add(len(active), len(fallback))
        if fallback:
            self._map_close_rounds(chrom, fallback, self._oracle())

    def _map_close_rounds(self, chrom: Chromosome,
                          reads: Sequence[SplitRead], backend) -> None:
        """Round-per-attempt path (one launch per schedule step)."""
        s = self.settings
        active = [r for r in reads if r.read_length > 0]
        # attempt schedule: (range_index, flip_before_attempt)
        schedule = [(0, False), (0, True), (1, False), (1, True)]
        for (range_index, flip) in schedule:
            if not active:
                break
            if flip:
                for r in active:
                    r.seq = dna.flip_rc(r.seq)
            batch_lanes = [[close_end_lane(chrom, r, range_index)]
                           for r in active]
            budgets = [self.budget(r) for r in active]
            for r, b in zip(active, budgets):
                r.max_snp_error = b[0]
            results = backend.run(
                batch_lanes, s.min_close,
                [b[0] for b in budgets], [b[1] for b in budgets])
            still: List[SplitRead] = []
            for r, (ups, full_mm) in zip(active, results):
                if ups:
                    r.up_close = ups
                    r.used = False
                    r.close_end_mismatch = full_mm
                else:
                    still.append(r)
            active = still
        # a read that failed all four attempts ends flipped relative to input,
        # exactly as the reference's persistent setUnmatchedSeq flips do.

    def finalize_close_ends(self, reads: Sequence[SplitRead]) -> List[SplitRead]:
        """Keep reads with close ends; chain-clean the anchor list.

        Reference: updateReadAfterCloseEndMapping, reader.cpp:1531-1554.
        """
        import time

        from pindel_tpu.profiling import g_timer
        t0 = time.monotonic()
        kept: List[SplitRead] = []
        for r in reads:
            if not r.up_close:
                continue
            r.used = False
            r.unique_read = True
            cl = r.up_close = clean_unique_points(r.up_close)
            loc0 = int(cl.loc[0])
            len0 = int(cl.length[0])
            if r.matched_d == PLUS:
                r.left_most_pos = loc0 + 1 - len0
            else:
                r.left_most_pos = loc0 + len0 - len(r.seq)
            if r.sample_name_to_number is None:
                r.sample_name_to_number = {r.tag: 1}
            kept.append(r)
        g_timer.add("search: finalize close", time.monotonic() - t0)
        return kept

    # -------------------------------------------------------------------- far
    def search_far_ends(self, chrom: Chromosome, reads: Sequence[SplitRead],
                        bd_regions: Optional[Callable[[SplitRead],
                                                      List[Tuple[Chromosome,
                                                                 int,
                                                                 int]]]] = None
                        ) -> None:
        """Fill read.up_far via escalating windows (and BD clusters first).

        Reference SearchFarEnd (pindel.cpp:1001-1074): the BreakDancer/RP
        window cluster is searched first; reads without a good far end
        then escalate geometric windows (span 64*4^k) around the close
        end.
        """
        s = self.settings
        active = [r for r in reads
                  if not r.mapper_split and r.up_close
                  and r.seq_codes()[0] != dna.N and not r.good_far_end_found()]

        if bd_regions is not None:
            with_bd = [(r, bd_regions(r)) for r in active]
            with_bd = [(r, regs) for r, regs in with_bd if regs]
            if with_bd:
                self._far_round([r for r, _ in with_bd],
                                [regs for _, regs in with_bd])
                active = [r for r in active if not r.good_far_end_found()]

        if hasattr(self.backend, "far_ends") and s.max_range_index <= 4:
            self._far_geometric_fused(chrom, active)
        else:
            self._far_geometric(chrom, active, self.backend)

    def search_far_ends_async(self, chrom: Chromosome,
                              reads: Sequence[SplitRead],
                              bd_regions=None):
        """Dispatch geometric far-end kernels without blocking (fused
        backends); token for ``search_far_ends_finish``.  BreakDancer
        evidence windows run first (synchronously — their kernels still
        queue behind any in-flight close chunks on the device, and they
        gate the geometric set, SearchFarEnd pindel.cpp:1001-1074)."""
        s = self.settings
        active = [r for r in reads
                  if not r.mapper_split and r.up_close
                  and r.seq_codes()[0] != dna.N
                  and not r.good_far_end_found()]
        if bd_regions is not None:
            with_bd = [(r, bd_regions(r)) for r in active]
            with_bd = [(r, regs) for r, regs in with_bd if regs]
            if with_bd:
                self._far_round([r for r, _ in with_bd],
                                [regs for _, regs in with_bd])
                active = [r for r in active
                          if not r.good_far_end_found()]
        if not (hasattr(self.backend, "far_ends_dispatch")
                and s.max_range_index <= 4):
            return (chrom, active, None, None)
        spans = [64 * 4 ** k for k in range(s.max_range_index + 1)]
        token = self.backend.far_ends_dispatch(active, spans,
                                               chrom.comp_size, bp_start=10)
        return (chrom, active, token, None)

    def search_far_ends_finish(self, far_token) -> None:
        chrom, active, token, _ = far_token
        if token is None:
            if hasattr(self.backend, "far_ends") and \
                    self.settings.max_range_index <= 4:
                self._far_geometric_fused(chrom, active)
            else:
                self._far_geometric(chrom, active, self.backend)
            return
        results = self.backend.far_ends_decode(active, token)
        self._consume_far_results(chrom, active, results)

    def _far_geometric_fused(self, chrom: Chromosome,
                             active: List[SplitRead]) -> None:
        """Fused path: all escalation rounds in one launch; non-uniform
        chains rerun on the oracle."""
        s = self.settings
        spans = [64 * 4 ** k for k in range(s.max_range_index + 1)]
        results = self.backend.far_ends(active, spans, chrom.comp_size,
                                        bp_start=10)
        self._consume_far_results(chrom, active, results)

    def _consume_far_results(self, chrom: Chromosome, active, results):
        from pindel_tpu.profiling import g_fallback
        fallback: List[SplitRead] = []
        for r, (chain, lane_minus, replaced, needs_fb) in zip(active,
                                                              results):
            if needs_fb:
                fallback.append(r)
                continue
            if not replaced:
                continue
            if chain is None:
                r.up_far = AnchorSet.empty()
            else:
                r.up_far = _anchorset_from_chain(chain, lane_minus,
                                                 lane_minus, chrom.name)
                r.far_end_mismatch = chain.full_mm
        g_fallback.add(len(active), len(fallback))
        if fallback:
            self._far_geometric(chrom, fallback, self._oracle())

    def _far_geometric(self, chrom: Chromosome, active: List[SplitRead],
                       backend) -> None:
        """Round-per-span escalation (one launch per span)."""
        s = self.settings
        span = 64
        for _k in range(1, s.max_range_index + 2):
            if not active:
                break
            regions = []
            for r in active:
                center = r.last_abs_loc_close_end()
                start = center - span if center > span + SPACER else SPACER
                if center + span + SPACER < chrom.comp_size:
                    end = center + span
                else:
                    end = chrom.comp_size - SPACER
                regions.append([(chrom, start, end)])
            self._far_round(active, regions, backend)
            active = [r for r in active if not r.good_far_end_found()]
            span *= 4

    def _oracle(self) -> "NumpyBackend":
        if self._fallback is None:
            self._fallback = NumpyBackend(self.settings, self.maxmm)
        return self._fallback

    def _far_round(self, reads: List[SplitRead],
                   regions: List[List[Tuple[Chromosome, int, int]]],
                   backend=None) -> None:
        """One batched far-end launch.  Reads whose candidate regions span
        a chromosome the device backend is not loaded with fall back to
        the exact-semantics NumPy backend."""
        if backend is None:
            backend = self.backend
        batch_lanes = [far_end_lanes(r, regs)
                       for r, regs in zip(reads, regions)]
        budgets = [self.budget(r) for r in reads]
        backend_chrom = getattr(backend, "chrom_name", None)
        main_idx: List[int] = []
        fallback_idx: List[int] = []
        for i, lanes in enumerate(batch_lanes):
            if backend_chrom is not None and any(
                    ln.chr_name != backend_chrom for ln in lanes):
                fallback_idx.append(i)
            else:
                main_idx.append(i)
        results: List = [None] * len(reads)
        if main_idx:
            out = backend.run(
                [batch_lanes[i] for i in main_idx],
                10,  # far-end min length, farend_searcher.cpp:90
                [budgets[i][0] for i in main_idx],
                [budgets[i][1] for i in main_idx])
            for i, res in zip(main_idx, out):
                results[i] = res
        if fallback_idx:
            out = self._oracle().run(
                [batch_lanes[i] for i in fallback_idx], 10,
                [budgets[i][0] for i in fallback_idx],
                [budgets[i][1] for i in fallback_idx])
            for i, res in zip(fallback_idx, out):
                results[i] = res
        for r, (ups, full_mm) in zip(reads, results):
            # NewUPFarIsBetter, farend_searcher.cpp:30-44
            new_max = int(ups.length[len(ups) - 1]) if ups else 0
            if new_max >= r.max_len_far():
                r.up_far = ups
                if ups:
                    r.far_end_mismatch = full_mm
