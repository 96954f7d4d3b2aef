"""glibc malloc tuning: retain freed pages in the heap.

The port's own copy of ``ipk_tpu/utils/malloc_tune.py``: only its imports
differ, so numerics, ordering, formats and messages stay those of the reference.

On the deployment sandboxes this framework targets, first-touch page faults
on fresh mmap'd allocations run at ~30 MB/s (measured: a 256 MB numpy copy
costs 10-20 s the first time, 0.2 s into already-touched pages).  Every
device→host transfer, concatenate, gather and serialize buffer in a build
allocates hundreds of MB, so the fault tax dominates the host stages.

glibc serves allocations above M_MMAP_THRESHOLD with fresh mmap's and
returns them to the kernel on free — paying the fault storm every time.
Raising the threshold and disabling trim keeps big buffers in the sbrk
heap, where pages stay resident after free and are reused already-touched:
the tax is paid once per high-water mark instead of once per allocation
(measured: repeated 256 MB copies drop from ~10 s to ~0.07 s).

Cost: the process RSS stays at its peak working set.  For build/bench/CLI
processes that exit when done this is the right trade; opt out with
``IPK_TPU_NO_MALLOC_TUNE=1`` (e.g. for long-lived servers on small hosts).

``mallopt`` is callable at runtime (no env vars needed), glibc-only; other
libcs no-op safely.
"""

from __future__ import annotations

import ctypes
import os
import sys

__all__ = ["retain_heap"]

_M_TRIM_THRESHOLD = -1
_M_MMAP_THRESHOLD = -3
_M_MMAP_MAX = -4

_done = False


def retain_heap() -> bool:
    """Apply the tuning once per process. Returns True when active."""
    global _done
    if _done:
        return True
    if os.environ.get("IPK_TPU_NO_MALLOC_TUNE") == "1":
        return False
    if not sys.platform.startswith("linux"):
        return False
    try:
        libc = ctypes.CDLL(None, use_errno=True)
        ok = (libc.mallopt(_M_MMAP_THRESHOLD, 2**31 - 1)
              and libc.mallopt(_M_TRIM_THRESHOLD, 2**31 - 1)
              and libc.mallopt(_M_MMAP_MAX, 0))
    except (OSError, AttributeError):
        return False
    _done = bool(ok)
    return _done
