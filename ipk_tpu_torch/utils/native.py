"""Build-on-demand loader for the native host libraries.

The port's counterpart of ``ipk_tpu/utils/native.py``. The C++ sources are
the repository's ``native/*.cpp``, shared with ``ipk_tpu``; the port builds
its own copies of the libraries, with the same portable flags (``-O3
-mtune=generic``, so the filter values stay bit-equal to ``ipk_tpu``'s),
into ``build/ipk_tpu_torch/native/`` under the repository root, never into
``native/``. Each build writes a private name and renames it into place, so
concurrent builders (test workers, ``ipk_tpu``'s own loader) never load a
half-written library.

``IPK_TPU_NO_NATIVE`` is honoured on every call (only a successfully loaded
handle is cached), so callers can force the pure-Python paths at any point.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

_REPO_DIR = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_SRC_DIR = os.path.join(_REPO_DIR, "native")
_BUILD_DIR = os.path.join(_REPO_DIR, "build", "ipk_tpu_torch", "native")
_handles: dict = {}
_failed: set = set()
_lock = threading.Lock()

#: portable flags: no -march=native (the build host's ISA extensions must
#: not leak into an artifact that could outlive the host)
_CXXFLAGS = ["-O3", "-mtune=generic", "-std=c++17", "-Wall"]


def _source(name: str) -> str:
    return os.path.join(_SRC_DIR, name.replace("lib", "", 1)
                        .replace(".so", ".cpp"))


def _build(name: str, extra: list) -> bool:
    src = _source(name)
    if not os.path.exists(src):
        return False
    out = os.path.join(_BUILD_DIR, name)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    try:
        os.makedirs(_BUILD_DIR, exist_ok=True)
        subprocess.run(["g++", *_CXXFLAGS, "-shared", "-fPIC", *extra,
                        "-o", tmp, src], check=True, capture_output=True)
        os.replace(tmp, out)
    except (subprocess.CalledProcessError, OSError):
        return False
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return True


def load_native_lib(name: str, *, extra_flags: Optional[list] = None
                    ) -> Optional[ctypes.CDLL]:
    """Load ``<build dir>/<name>``, compiling it from ``native/``'s
    same-named ``.cpp`` if missing or older than its source. Returns None
    (pure-Python fallback) when IPK_TPU_NO_NATIVE is set, the toolchain is
    unavailable, or the build fails — never raises."""
    if os.environ.get("IPK_TPU_NO_NATIVE"):
        return None
    with _lock:
        if name in _handles:
            return _handles[name]
        if name in _failed:
            return None
        path = os.path.join(_BUILD_DIR, name)
        src = _source(name)
        stale = (not os.path.exists(path)
                 or (os.path.exists(src)
                     and os.path.getmtime(path) < os.path.getmtime(src)))
        if stale and not _build(name, extra_flags or []):
            _failed.add(name)
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            _failed.add(name)
            return None
        _handles[name] = lib
        return lib
