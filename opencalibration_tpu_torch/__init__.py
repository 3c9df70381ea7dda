"""PyTorch + CUDA port of opencalibration_tpu.

The package mirrors the JAX package's subpackage and module names, so every
module's twin sits at the same relative path. It imports ``torch`` and never
``jax``: the JAX package stays the reference, and only the parity tests import
both.

Conventions kept at public functions, so a caller can compare like with like:
pixel coordinates are (x = col, y = row), quaternions are (w, x, y, z), and
binary descriptors are 16 packed 32-bit words per 486-bit descriptor. Torch
has no usable ``uint32`` arithmetic, so the words travel as ``int32`` tensors
holding the same bit patterns (``interop`` converts at the boundary).

Every function that creates tensors from nothing takes an explicit
``device``; work on a CUDA tensor never falls back to the CPU.
"""
