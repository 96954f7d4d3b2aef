"""ipk_tpu_torch: the PyTorch/CUDA port of ipk_tpu.

The same phylo-k-mer database build as ``ipk_tpu``, run with PyTorch on an
NVIDIA GPU. The JAX package stays the reference: every stage here is held
bit-equal (arrays) or payload-equal (``.ipk`` files) against it.

What is ported so far is ``build`` on the dense path (σ^k < 2^24: DNA
k ≤ 11, AA k ≤ 5) and on the sparse large-k path (σ^k ≥ 2^24), with their
kernels hand-written in CUDA C++ for Hopper: ``combine_max``
(``core/csrc/combine_max.cu``) and ``staircase_select``
(``core/csrc/staircase_select.cu``). Framework-free host code (alignment,
tree, AR reader, filters, serialization, diff/dump) is imported from
``ipk_tpu``'s jax-free modules, never copied.

Layers:
  device               the one torch.device a build runs on
  core.dense           masked half tensors, plain combine, group max, compaction
  core.sparse          capped survivor lists per span, plain staircase, merge
  core.kernels         the CUDA kernel wrappers (plain version on CPU tensors)
  host                 numpy stage-2/3 helpers (extract, filter, sort)
  builder / pipeline   stage 1-3 orchestration
  cli                  ``python -m ipk_tpu_torch build|diff|dump``
"""

__version__ = "0.1.0"
