"""Wrappers of the hand-written CUDA kernels: the counterpart of
``ipk_tpu/core/pallas_kernels.py``.

A wrapper takes its kernel's plain PyTorch version for tensors on the CPU,
and only there. For CUDA tensors it launches the kernel (built from
``core/csrc/`` at first use, see ``core._build``) or raises; nothing falls
back. Each wrapper counts its kernel launches in a plain integer attribute,
``<wrapper>.launches``, so a run can show that its main path went through
the kernel.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _build
from .dense import combine_max_ref

__all__ = ["combine_max"]


def _check_eps(eps: torch.Tensor) -> float:
    if not (isinstance(eps, torch.Tensor) and eps.dim() == 0
            and eps.dtype == torch.float32):
        raise TypeError("eps must be a 0-d float32 tensor")
    return float(eps)     # exact: an f32 value round-trips through f64


def combine_max(L: torch.Tensor, R: torch.Tensor, eps: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``A[g, i, j] = max_w (L[g, w, i] + R[g, w, j])``, ``-inf`` where
    ``<= eps``, plus per-ghost int64 counts of ``L + R > eps``.

    L: [G, W, nl], R: [G, W, nr] contiguous float32 on one device; eps: 0-d
    float32. Returns (A [G, nl, nr] float32, counts [G] int64) on that device.
    CPU tensors go to :func:`combine_max_ref`; CUDA tensors to the kernel in
    ``csrc/combine_max.cu``.
    """
    eps_f = _check_eps(eps)
    if L.dim() != 3 or R.dim() != 3 or L.shape[:2] != R.shape[:2]:
        raise ValueError(f"combine_max: L {tuple(L.shape)} and R "
                         f"{tuple(R.shape)} must be [G, W, nl] and [G, W, nr]")
    if L.dtype != torch.float32 or R.dtype != torch.float32:
        raise TypeError(f"combine_max: L and R must be float32, got "
                        f"{L.dtype} and {R.dtype}")
    if L.device != R.device:
        raise ValueError(f"combine_max: L on {L.device}, R on {R.device}")
    if L.device.type == "cpu":
        return combine_max_ref(L, R, eps)
    if L.device.type != "cuda":
        raise ValueError(f"combine_max: unsupported device {L.device}")
    if not (L.is_contiguous() and R.is_contiguous()):
        raise ValueError("combine_max: L and R must be contiguous")
    lib = _build.load()
    G, W, nl = L.shape
    nr = R.shape[2]
    A = torch.empty((G, nl, nr), dtype=torch.float32, device=L.device)
    counts = torch.zeros(G, dtype=torch.int64, device=L.device)
    stream = torch.cuda.current_stream(L.device).cuda_stream
    rc = lib.ipk_combine_max(
        ctypes.c_void_p(L.data_ptr()), ctypes.c_void_p(R.data_ptr()),
        ctypes.c_float(eps_f), ctypes.c_void_p(A.data_ptr()),
        ctypes.c_void_p(counts.data_ptr()), G, W, nl, nr, L.device.index,
        ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"combine_max kernel launch failed: CUDA error "
                           f"{rc} ({lib.ipk_cuda_error_string(rc).decode()})")
    combine_max.launches += 1
    return A, counts


combine_max.launches = 0
