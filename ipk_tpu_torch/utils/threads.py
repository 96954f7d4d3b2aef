"""Central host-thread budget.

The port's own copy of ``ipk_tpu/utils/threads.py``: only its imports differ,
so numerics, ordering, formats and messages stay those of the reference.

The reference accepts ``--threads`` but forwards it only to the AR
subprocess (``command_line.cpp:123-124``; raxml-ng's ``--threads``).  This
framework has real host thread pools — the native mif0 filter, the
pigz-style parallel deflate, the entry range-gather — which previously
listened only to per-pool env vars.  ``--threads`` now reaches all of them
through this module:

resolution order for every pool (first hit wins):

1. the pool-specific env var (``IPK_TPU_FILTER_THREADS``,
   ``IPK_TPU_ZLIB_THREADS``), for surgical overrides;
2. the global ``IPK_TPU_THREADS`` env var;
3. the value configured by the CLI/pipeline via :func:`set_host_threads`
   (``--threads N`` with N >= 1);
4. auto: ``os.cpu_count()``, clamped by the pool's cap.

``--threads 0`` (the CLI default) means auto — a deliberate deviation from
the reference's default of 1, which there only throttles raxml-ng.
"""

from __future__ import annotations

import os
from typing import Optional

__all__ = ["set_host_threads", "host_threads"]

_configured: Optional[int] = None


def set_host_threads(n: Optional[int]) -> None:
    """Pin every host thread pool to ``n`` threads (``--threads N``).
    ``None`` or ``n <= 0`` restores auto sizing."""
    global _configured
    _configured = int(n) if n and int(n) > 0 else None


def host_threads(env_var: Optional[str] = None, cap: int = 16) -> int:
    """Resolve the thread count for one pool (see module docstring)."""
    for var in ([env_var] if env_var else []) + ["IPK_TPU_THREADS"]:
        v = os.environ.get(var)
        if v:
            return max(1, int(v))
    if _configured is not None:
        return _configured
    return max(1, min(os.cpu_count() or 1, cap))
