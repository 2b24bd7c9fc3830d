"""PyTorch/CUDA port of the ``repro`` serving stack (see README.md).

Mirrors the reference package's module names: ``configs``, ``core``,
``kernels``, ``models``, ``serve``; ``bridge`` loads the reference's
parameter trees. Imports nothing of JAX or of ``repro``.
"""
