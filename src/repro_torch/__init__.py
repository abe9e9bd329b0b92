"""PyTorch/CUDA port of the AdaSplit reproduction.

A second package beside the JAX reference ``repro``: same module layout
and names, PyTorch idiom inside.  It imports ``torch`` and numpy only —
never ``jax`` and nothing of ``repro`` — and its entry points run on the
CUDA card unless the caller passes ``device="cpu"``.

Each Pallas kernel of the reference becomes a CUDA C++ kernel for
Hopper (``kernels/csrc``), built with nvcc at first use and bound with
ctypes; beside each sits a plain PyTorch version of the same function,
taken only for tensors that lie on the CPU.
"""
