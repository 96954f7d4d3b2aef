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
from .dense import combine_max_ref, combine_max_with_positions_ref

__all__ = ["combine_max", "combine_max_with_positions", "staircase_select"]


def _check_eps(eps: torch.Tensor) -> float:
    if not (isinstance(eps, torch.Tensor) and eps.dim() == 0
            and eps.dtype == torch.float32):
        raise TypeError("eps must be a 0-d float32 tensor")
    return float(eps)     # exact: an f32 value round-trips through f64


def _check_halves(name: str, L: torch.Tensor, R: torch.Tensor) -> None:
    """Raise unless L [G, W, nl] and R [G, W, nr] are float32 on one CPU or
    CUDA device (and contiguous there)."""
    if L.dim() != 3 or R.dim() != 3 or L.shape[:2] != R.shape[:2]:
        raise ValueError(f"{name}: L {tuple(L.shape)} and R "
                         f"{tuple(R.shape)} must be [G, W, nl] and [G, W, nr]")
    if L.dtype != torch.float32 or R.dtype != torch.float32:
        raise TypeError(f"{name}: L and R must be float32, got "
                        f"{L.dtype} and {R.dtype}")
    if L.device != R.device:
        raise ValueError(f"{name}: L on {L.device}, R on {R.device}")
    if L.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {L.device}")
    if L.device.type == "cuda" and not (L.is_contiguous()
                                        and R.is_contiguous()):
        raise ValueError(f"{name}: L and R must be contiguous")


def _raise_on_launch_error(lib, name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error "
                           f"{rc} ({lib.ipk_cuda_error_string(rc).decode()})")


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
    _check_halves("combine_max", L, R)
    if L.device.type == "cpu":
        return combine_max_ref(L, R, eps)
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
    _raise_on_launch_error(lib, "combine_max", rc)
    combine_max.launches += 1
    return A, counts


combine_max.launches = 0


def combine_max_with_positions(L: torch.Tensor, R: torch.Tensor,
                               eps: torch.Tensor
                               ) -> Tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]:
    """:func:`combine_max` plus, per cell, the earliest window of its
    maximum (the ``--keep-positions`` accumulator).

    Same inputs and checks as :func:`combine_max`. Returns (A [G, nl, nr]
    float32, pos [G, nl, nr] int32, counts [G] int64); dead cells are
    (-inf, 0). CPU tensors go to :func:`combine_max_with_positions_ref` (at
    ``ipk_tpu``'s window block of 32, which the kernel follows); CUDA tensors
    to the positions mode of the kernel in ``csrc/combine_max.cu``.
    """
    eps_f = _check_eps(eps)
    _check_halves("combine_max_with_positions", L, R)
    if L.device.type == "cpu":
        return combine_max_with_positions_ref(L, R, eps)
    lib = _build.load()
    G, W, nl = L.shape
    nr = R.shape[2]
    A = torch.empty((G, nl, nr), dtype=torch.float32, device=L.device)
    pos = torch.empty((G, nl, nr), dtype=torch.int32, device=L.device)
    counts = torch.zeros(G, dtype=torch.int64, device=L.device)
    stream = torch.cuda.current_stream(L.device).cuda_stream
    rc = lib.ipk_combine_max_positions(
        *(ctypes.c_void_p(t.data_ptr()) for t in (L, R)),
        ctypes.c_float(eps_f),
        *(ctypes.c_void_p(t.data_ptr()) for t in (A, pos, counts)),
        G, W, nl, nr, L.device.index, ctypes.c_void_p(stream))
    _raise_on_launch_error(lib, "combine_max_with_positions", rc)
    combine_max_with_positions.launches += 1
    return A, pos, counts


combine_max_with_positions.launches = 0

def staircase_select(sL: torch.Tensor, cL: torch.Tensor, sR: torch.Tensor,
                     cR: torch.Tensor, eps: torch.Tensor, *, cap: int,
                     sort_l: bool = True
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                torch.Tensor]:
    """Capacity-bounded threshold combine of two survivor lists per window.

    sL/cL: [G, W, CL] float32 scores / int64 codes, sR/cR: [G, W, CR]
    likewise, in any order; eps: [G, W] float32. Codes are int64 holding
    unsigned 32-bit values in [0, 2^32) on both sides of the C boundary; the
    kernel compares them as unsigned 32-bit. Returns (code_l, code_r
    [G, W, cap] int64, scores [G, W, cap] float32, totals [G, W] int32): the
    pairs with ``fl(sL[i] + sR[j]) > eps`` over the (score desc, code asc)
    sorted views (L sorted only with ``sort_l``), row-major; dead slots are
    (-inf, 0, 0); totals above ``cap`` mean the window overflowed.

    Lists and cap may be of any size with ``CL * CR < 2^31`` (totals and
    row offsets are int32, as in ``ipk_tpu``), on every device. CPU tensors
    go to :func:`sparse.staircase_select_ref`; CUDA tensors to the kernel in
    ``csrc/staircase_select.cu``, into a scratch allocated here for the
    windows a warp cannot hold (their queue, and the staging of those too
    wide for shared memory).
    """
    if not (sL.dim() == 3 and cL.shape == sL.shape and sR.dim() == 3
            and cR.shape == sR.shape and sL.shape[:2] == sR.shape[:2]
            and eps.shape == sL.shape[:2]):
        raise ValueError(
            f"staircase_select: sL/cL {tuple(sL.shape)}/{tuple(cL.shape)}, "
            f"sR/cR {tuple(sR.shape)}/{tuple(cR.shape)} and eps "
            f"{tuple(eps.shape)} must be [G, W, CL], [G, W, CR] and [G, W]")
    if (sL.dtype != torch.float32 or sR.dtype != torch.float32
            or eps.dtype != torch.float32):
        raise TypeError("staircase_select: scores and eps must be float32")
    if cL.dtype != torch.int64 or cR.dtype != torch.int64:
        raise TypeError(f"staircase_select: codes must be int64, got "
                        f"{cL.dtype} and {cR.dtype}")
    if len({t.device for t in (sL, cL, sR, cR, eps)}) != 1:
        raise ValueError("staircase_select: all inputs must be on one device")
    G, W, CL = sL.shape
    CR = sR.shape[2]
    if CL < 1 or CR < 1 or cap < 1:
        raise ValueError(f"staircase_select: empty lists or cap (CL={CL}, "
                         f"CR={CR}, cap={cap})")
    if CL * CR >= 1 << 31:
        raise ValueError(
            f"staircase_select: lists of {CL} x {CR} reach 2^31 pairs; "
            f"totals and row offsets are int32")
    if sL.device.type == "cpu":
        from .sparse import staircase_select_ref
        return staircase_select_ref(sL, cL, sR, cR, eps, cap=cap,
                                    sort_l=sort_l)
    if sL.device.type != "cuda":
        raise ValueError(f"staircase_select: unsupported device {sL.device}")
    if not all(t.is_contiguous() for t in (sL, cL, sR, cR, eps)):
        raise ValueError("staircase_select: inputs must be contiguous")
    dev = sL.device
    out_cl = torch.empty((G, W, cap), dtype=torch.int64, device=dev)
    out_cr = torch.empty((G, W, cap), dtype=torch.int64, device=dev)
    out_s = torch.empty((G, W, cap), dtype=torch.float32, device=dev)
    totals = torch.empty((G, W), dtype=torch.int32, device=dev)
    if G * W == 0:
        return out_cl, out_cr, out_s, totals
    lib = _build.load()
    nbytes = lib.ipk_staircase_scratch_bytes(G * W, CL, CR, dev.index)
    if nbytes < 0:
        raise RuntimeError("staircase_select: the device's shared-memory "
                           "limit could not be read")
    scratch = (torch.empty(nbytes, dtype=torch.uint8, device=dev)
               if nbytes else None)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.ipk_staircase_select(
        *(ctypes.c_void_p(t.data_ptr()) for t in
          (sL, cL, sR, cR, eps, out_cl, out_cr, out_s, totals)),
        ctypes.c_void_p(None if scratch is None else scratch.data_ptr()),
        G * W, CL, CR, cap, int(sort_l), dev.index, ctypes.c_void_p(stream))
    _raise_on_launch_error(lib, "staircase_select", rc)
    staircase_select.launches += 1
    return out_cl, out_cr, out_s, totals


staircase_select.launches = 0
