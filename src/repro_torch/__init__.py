"""AFL on PyTorch and CUDA: the port of the JAX package ``repro``.

Module for module like ``repro``, importing nothing of it or of JAX. Entry
points run on CUDA unless the caller passes ``device="cpu"``; the kernels
of the main path are hand-written for Hopper (``kernels/csrc``), with
plain PyTorch versions for the CPU.
"""
