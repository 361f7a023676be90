"""Delta Tensor's store in PyTorch, with hand-written CUDA kernels.

The port of ``repro`` (JAX + Pallas) to PyTorch on an NVIDIA H100. It keeps
its own copy of the host storage engine (``repro_torch.lake``,
``repro_torch.core``), which reads and writes the same tables byte for
byte, and lands tensors on the card through ``repro_torch.lake.device`` and
the CUDA kernels of ``repro_torch.kernels``. On top of the store sit the
data loaders (``repro_torch.data``), the ``dense`` and ``moe`` models
(``repro_torch.models``), serving (``repro_torch.serve``) and training
(``repro_torch.train``: AdamW, the plain and compressed train steps,
``DeltaCheckpointer``). It imports torch, numpy and the standard library
(ml_dtypes when present), never jax or ``repro``.
"""
