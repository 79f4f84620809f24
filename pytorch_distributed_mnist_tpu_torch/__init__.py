"""PyTorch/CUDA port of ``pytorch_distributed_mnist_tpu``.

The JAX package beside this one is the reference; each module here keeps
its counterpart's path (``serve/engine.py`` <-> ``serve/engine.py``).
What is ported:

- training of ``cnn``, ``linear`` and the ViT through the bare command
  (``python -m pytorch_distributed_mnist_tpu_torch``), in the scan mode
  (one captured CUDA graph of the step replayed per batch), stepwise and
  explicit modes, with full-state checkpoints that load in either package,
  resume and ``-e``;
- data parallelism over processes, one device each (``parallel/``):
  ``--spawn N`` or the explicit rendezvous, NCCL on the card and gloo on
  the CPU, the gradient mean inside the captured step, sharded eval and
  rank-0 checkpoints;
- serving of ``cnn``, ``linear`` and the ViT (``python -m
  pytorch_distributed_mnist_tpu_torch serve``) at every precision plane;
- run supervision (``runtime/``: agreed exits, watchdogs, fault points,
  elastic shrink and grow), the native C++ host data path
  (``data/native.py``), ``--download`` and the build directory
  (``utils/compile_cache.py``).

Every Pallas kernel of the reference has a hand-written CUDA kernel for
Hopper under ``csrc/``: the cross-entropy, Adam, flash attention and the
int8 plane's matrix product.

This package imports ``torch``, numpy and the standard library only:
never JAX, and nothing of the JAX package.
"""
