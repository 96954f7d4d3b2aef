"""ipk_tpu_torch: the PyTorch/CUDA port of ipk_tpu.

The same phylo-k-mer database build as ``ipk_tpu``, run with PyTorch on an
NVIDIA GPU. The JAX package stays the reference: every stage here is held
bit-equal (arrays) or payload-equal (``.ipk`` files) against it.

What is ported: ``build`` on the dense path (σ^k < 2^24: DNA k ≤ 11, AA
k ≤ 5), with ``--keep-positions``, and on the sparse large-k path (σ^k ≥
2^24), both with ``--on-disk``; the native AR (``--ar native``,
``--ar-optimize``); ``place``. The kernels are hand-written in CUDA C++ for
Hopper: ``combine_max`` with its positions mode
(``core/csrc/combine_max.cu``) and ``staircase_select``
(``core/csrc/staircase_select.cu``). The port imports nothing of
``ipk_tpu``: its framework-free host code (alignment, tree, AR reader and
bridge, filters, serialization, host placement scorer, diff/dump) is its
own copy of ``ipk_tpu``'s jax-free modules, under the same relative paths,
and the helpers of ``ipk_tpu`` modules that import jax are copied into
``host`` and ``ar``. The native host libraries are built from the
repository's ``native/*.cpp`` into ``build/ipk_tpu_torch/native/``. Not
ported: builds over more than one device and ``--profile``.

Layers:
  seq / tree / alignment / db / serialize / tools / utils
                       host modules (copies of ipk_tpu's jax-free ones)
  ar.bridge / ar.reader / ar.mapping, core.filter
                       AR subprocess and replay, posteriors, mif0/random
  device               the one torch.device a build runs on
  core.dense           masked half tensors, plain combine (with positions),
                       group max, compaction
  core.sparse          capped survivor lists per span, plain staircase, merge
  core.kernels         the CUDA kernel wrappers (plain version on CPU tensors)
  host                 numpy stage-2/3 helpers (extract, filter, sort,
                       on-disk merge)
  builder / pipeline   stage 1-3 orchestration
  ar.native / ar.optimize  native AR posteriors (f32) and ML fit (f64)
  placement            device placement scorer
  cli                  ``python -m ipk_tpu_torch build|diff|diff-text|dump|place``
"""

__version__ = "0.1.0"
