"""AFL on PyTorch and CUDA: the port of the JAX package ``repro``.

Module for module like ``repro``, importing nothing of it or of JAX. Entry
points run on CUDA unless the caller passes ``device="cpu"``; the kernels
of the main path are hand-written for Hopper (``kernels/csrc``), with
plain PyTorch versions for the CPU.

The reference's ``compat.py`` has no counterpart: it shims two jax renames
(the Pallas TPU compiler params, ``shard_map``'s location), and the port
meets neither. Its toolchain flags sit in one place,
``kernels/build.py``; a shim goes there when a torch or CUDA version drift
shows up.
"""
