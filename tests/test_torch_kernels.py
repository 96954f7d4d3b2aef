"""ipk_tpu_torch.core.kernels: the CUDA kernel wrappers.

On the CPU a wrapper takes its plain version and leaves its launch count
alone; the kernel itself runs only on a card, in the tests marked ``cuda``
(skipped where ``torch.cuda.is_available()`` is false). Tolerance: none; the
kernel's arithmetic is exactly rounded f32 add / max / compare.
"""

import numpy as np
import pytest
import torch

from ipk_tpu_torch.core import dense, kernels

torch.set_num_threads(2)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    return torch.device("cuda")


def halves(seed, G=2, W=13, nl=12, nr=20, device="cpu"):
    rng = np.random.default_rng(seed)
    L = rng.normal(size=(G, W, nl)).astype(np.float32)
    R = rng.normal(size=(G, W, nr)).astype(np.float32)
    L[rng.random(L.shape) < 0.2] = -np.inf
    return (torch.from_numpy(L).to(device), torch.from_numpy(R).to(device),
            torch.tensor(np.float32(0.5), device=device))


def test_import_builds_nothing():
    """Importing the wrappers needs no nvcc and builds no library."""
    from ipk_tpu_torch.core import _build
    assert _build._lib is None
    assert _build.LIB_PATH.endswith("build/ipk_tpu_torch/libipk_kernels.so")


def test_cpu_tensor_takes_plain_version():
    L, R, eps = halves(1)
    before = kernels.combine_max.launches
    A, counts = kernels.combine_max(L, R, eps)
    A_ref, counts_ref = dense.combine_max_ref(L, R, eps)
    assert kernels.combine_max.launches == before
    assert torch.equal(A, A_ref) and torch.equal(counts, counts_ref)


@pytest.mark.parametrize("bad", ["L_f64", "R_f64", "eps_float", "eps_f64",
                                 "shape"])
def test_wrapper_rejects_bad_input(bad):
    L, R, eps = halves(2)
    if bad == "L_f64":
        L = L.double()
    elif bad == "R_f64":
        R = R.double()
    elif bad == "eps_float":
        eps = 0.5
    elif bad == "eps_f64":
        eps = eps.double()
    else:
        R = R[:, :-1]
    with pytest.raises((TypeError, ValueError)):
        kernels.combine_max(L, R, eps)


@pytest.mark.cuda
@pytest.mark.parametrize("G,W,nl,nr", [(2, 13, 12, 20), (3, 70, 33, 65),
                                       (2, 40, 400, 400), (1, 0, 8, 8)])
def test_kernel_matches_plain_on_card(cuda_device, G, W, nl, nr):
    L, R, eps = halves(3, G, W, nl, nr, device=cuda_device)
    before = kernels.combine_max.launches
    A, counts = kernels.combine_max(L, R, eps)
    torch.cuda.synchronize()
    assert kernels.combine_max.launches == before + 1
    A_ref, counts_ref = dense.combine_max_ref(L, R, eps)
    assert torch.equal(A, A_ref)
    assert torch.equal(counts, counts_ref)


@pytest.mark.cuda
def test_kernel_rejects_non_contiguous(cuda_device):
    L, R, eps = halves(4, nl=16, device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.combine_max(L[:, :, :8], R, eps)
