"""The kernels: hand-written CUDA for the H100 (``csrc/``), their plain
PyTorch versions (``ref``) and the device dispatcher (``ops``).  Each
wrapper counts its launches (``lease_probe.launches``, ...,
``ssd_chunk.launches``)."""
