"""Phase timers, log stream and read-intake counters (observability).

Mirrors the reference's coarse observability surface:

* ``Timer``/``TimerItem`` wall-clock phase accounting printed at exit
  (reference pindel.cpp:1177-1260, switched at :1587/:1783/:1835/:1886/:1923
  and dumped at :2010);
* the global ``logStream`` that ``-L`` redirects to a file
  (reference pindel.cpp:839-842, logstream.h);
* per-window read-intake counters (reference reader.cpp:57-62 and
  ``showReadStats`` reader.cpp:183-193).

This build adds finer-grained sub-phases (device launches, host decode,
report emission) under the same registry so that ``--profile`` output
doubles as a kernel-level profile.
"""
from __future__ import annotations

import sys
import time
from contextlib import contextmanager
from typing import Dict, List, Optional, TextIO


class Timer:
    """Named wall-clock phase accumulator.

    Like the reference's ``Timer`` (pindel.cpp:1177-1260) this keeps one
    running phase at a time for the coarse phases, but also supports
    re-entrant sub-phases via ``phase()`` contexts.
    """

    def __init__(self) -> None:
        self._acc: Dict[str, float] = {}
        self._order: List[str] = []
        self._t0 = time.monotonic()

    def add(self, name: str, seconds: float) -> None:
        if name not in self._acc:
            self._acc[name] = 0.0
            self._order.append(name)
        self._acc[name] += seconds

    @contextmanager
    def phase(self, name: str):
        t0 = time.monotonic()
        try:
            yield
        finally:
            self.add(name, time.monotonic() - t0)

    def reset(self) -> None:
        self._acc.clear()
        self._order.clear()
        self._t0 = time.monotonic()

    def report(self, stream=None, coarse_only: bool = False) -> str:
        """Phase report in the reference's exit format (pindel.cpp:1245-1258).

        ``coarse_only`` hides the fine-grained sub-phases (names with a
        ``:``-prefixed component, e.g. ``fused: close kernel``) so the
        default exit dump matches the reference's 5-phase granularity;
        ``--profile`` prints everything."""
        total = sum(self._acc.values())
        wall = time.monotonic() - self._t0
        head = "Timer report (wall %.3fs, accounted %.3fs):" % (wall, total)
        if total > wall:
            # software pipelining overlaps device phases with host phases,
            # so phase times can double-count wall time
            head += "  [phases overlap under pipelining]"
        lines = [head]
        for name in self._order:
            if coarse_only and ":" in name:
                continue
            sec = self._acc[name]
            pct = 100.0 * sec / total if total > 0 else 0.0
            lines.append("  %-52s %9.3fs %5.1f%%" % (name, sec, pct))
        text = "\n".join(lines)
        if stream is not None:
            stream.write(text + "\n")
        return text

    def items(self) -> Dict[str, float]:
        return dict(self._acc)


g_timer = Timer()


class LogStream:
    """Global log sink: stderr by default, a file when ``-L`` is set.

    The reference logs to stdout (pindel.cpp:839-842); we default to
    stderr so stdout stays clean for machine-readable output (bench JSON,
    converter pipelines)."""

    def __init__(self) -> None:
        self._fh: TextIO = sys.stderr
        self._owned = False

    def redirect(self, path: str) -> None:
        self.close()
        self._fh = open(path, "w")
        self._owned = True

    def close(self) -> None:
        if self._owned:
            self._fh.close()
            self._owned = False
            self._fh = sys.stderr

    def write(self, msg: str) -> None:
        self._fh.write(msg)

    def info(self, msg: str) -> None:
        self._fh.write(msg + "\n")

    def flush(self) -> None:
        self._fh.flush()


g_log = LogStream()


class ReadStats:
    """Per-window intake counters (reference reader.cpp:57-62, 183-193)."""

    FIELDS = ("scanned", "in_window", "close_mapped_plus",
              "close_mapped_minus", "far_mapped")

    def __init__(self) -> None:
        for f in self.FIELDS:
            setattr(self, f, 0)

    def reset(self) -> None:
        for f in self.FIELDS:
            setattr(self, f, 0)

    def show(self, window_desc: str, log: Optional[LogStream] = None) -> str:
        """showReadStats-equivalent line (reader.cpp:183-193)."""
        text = ("Window %s: reads scanned %d, in window %d, "
                "close end mapped +%d/-%d, far end mapped %d" % (
                    window_desc, self.scanned, self.in_window,
                    self.close_mapped_plus, self.close_mapped_minus,
                    self.far_mapped))
        (log or g_log).info(text)
        return text


g_read_stats = ReadStats()


class FallbackStats:
    """Fused-engine fallback counters: reads whose device result could not
    be decoded exactly (non-uniform chains, jumbo metadata) re-run on the
    exact-semantics NumPy oracle.  The fused design assumes this is rare
    (~0% on uniform scenes); golden tests assert the measured ratio so a
    scene shape that breaks chain uniformity becomes a test failure, not
    a silent perf cliff."""

    def __init__(self) -> None:
        self.total = 0
        self.fallback = 0

    def add(self, total: int, fallback: int) -> None:
        self.total += total
        self.fallback += fallback

    def reset(self) -> None:
        self.total = 0
        self.fallback = 0

    def ratio(self) -> float:
        return self.fallback / self.total if self.total else 0.0


g_fallback = FallbackStats()
