"""HALCONE on PyTorch + CUDA: the port of ``repro``'s lease-coherent
fabric to an NVIDIA H100.

The package never imports JAX or ``repro``; the tests hold it against
``repro`` on identical inputs.  Entry points (``ArrayFabric``,
``default_fabric``, ``BatchedKVLease``) run on the CUDA device unless the
caller passes ``device="cpu"``; on the CPU every kernel wrapper uses its
plain PyTorch version (``kernels/ref.py``).
"""
