"""Native (C++) components, compiled from the sources here with g++ on
first use and loaded via ctypes.  The shared objects are built next to
the sources (they are not committed) and rebuilt whenever a source file
is newer.  Concurrent first uses — pytest-xdist workers, multi-process
runs — serialize on a lock file, and each build writes a temp name of
its own before the atomic rename."""
from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
import threading

_DIR = os.path.dirname(os.path.abspath(__file__))
_LOCK = threading.Lock()
_LIBS = {}


def _stale(so_path: str, srcs) -> bool:
    return (not os.path.exists(so_path)
            or any(os.path.getmtime(s) > os.path.getmtime(so_path)
                   for s in srcs))


def _build(name: str, sources, link=("-lz",), cflags=()) -> str:
    so_path = os.path.join(_DIR, f"lib{name}.so")
    srcs = [os.path.join(_DIR, s) for s in sources]
    if not _stale(so_path, srcs):
        return so_path
    with open(so_path + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if _stale(so_path, srcs):       # another process may have built it
            tmp = f"{so_path}.{os.getpid()}.tmp"
            cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", *cflags,
                   *srcs, "-o", tmp, *link]
            r = subprocess.run(cmd, capture_output=True, text=True)
            if r.returncode != 0:
                raise RuntimeError(f"building lib{name}.so failed:\n"
                                   f"{' '.join(cmd)}\n{r.stderr}")
            os.replace(tmp, so_path)
    return so_path


def load(name: str, sources, link=("-lz",), cflags=()) -> ctypes.CDLL:
    with _LOCK:
        if name not in _LIBS:
            _LIBS[name] = ctypes.CDLL(_build(name, sources, link, cflags))
        return _LIBS[name]
