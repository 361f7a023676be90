"""Delta Tensor's store in PyTorch, with hand-written CUDA kernels.

The port of ``repro`` (JAX + Pallas) to PyTorch on an NVIDIA H100. It keeps
its own copy of the host storage engine (``repro_torch.lake``,
``repro_torch.core``), which reads and writes the same tables byte for
byte, and lands tensors on the card through ``repro_torch.lake.device`` and
the CUDA kernels of ``repro_torch.kernels``. It imports torch, numpy and
the standard library (ml_dtypes when present), never jax or ``repro``.
"""
