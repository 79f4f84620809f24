"""PyTorch/CUDA port of ``pytorch_distributed_mnist_tpu``.

The JAX package beside this one is the reference; each module here keeps
its counterpart's path (``serve/engine.py`` <-> ``serve/engine.py``).
What is ported so far is the serving path of ``cnn`` and ``linear``
(``python -m pytorch_distributed_mnist_tpu_torch serve``), with the int8
plane's matrix product as a hand-written CUDA kernel for Hopper
(``csrc/matmul_i8.cu``). Training is not ported yet.

This package imports ``torch``, numpy and the standard library only:
never JAX, and nothing of the JAX package.
"""
