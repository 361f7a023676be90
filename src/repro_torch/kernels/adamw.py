"""adamw: one AdamW step over one leaf, in place.

``launch`` runs the CUDA kernel of ``csrc/adamw.cu`` (one pass over the
leaf; it replaces no Pallas kernel: the reference's update is fused by XLA);
``plain`` is the port's per-op update of one leaf in plain PyTorch, which
the CPU path, meta tensors and DTensor leaves run and the card checks the
kernel against. Both write the new ``m``, ``v`` and ``p`` into the tensors
they are given, in the reference's order (``repro.train.optimizer``):
``g * scale`` in f32, the moments, the bias-corrected step, decoupled
weight decay on leaves of two or more dimensions, then ``p - lr * step``
rounded to the param dtype. ``scale``, ``lr``, ``b1c`` and ``b2c`` are the
step's 0-d f32 tensors on the params' device.

``g`` may be a broadcast view of ``p``'s shape (the compressed step's mean
expanded over a leading pod axis, stride 0): ``launch`` reads its
contiguous inner tensor and never materialises the broadcast.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Tuple

import torch

from . import _build

launches = 0  # kernel launches since the last reset (set to 0 to reset)
_count_lock = threading.Lock()
# element kinds of g and p in csrc/adamw.cu, in its order
KINDS = (torch.float32, torch.float16, torch.bfloat16)
_GROUP = 4  # elements of one vector access in csrc/adamw.cu


def plain(g: torch.Tensor, p: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
          scale: torch.Tensor, lr: torch.Tensor, b1c: torch.Tensor,
          b2c: torch.Tensor, *, b1: float, b2: float, eps: float,
          weight_decay: float) -> None:
    """The step in plain PyTorch, one op at a time. DTensor leaves may be
    laid out differently from their moments (ZeRO-1): the gradient is moved
    to its moments' placements, and the step to its param's."""
    from ..dist.sharding import laid_out_as  # dist imports the lake, which imports kernels
    g32 = laid_out_as(g.to(torch.float32, copy=True).mul_(scale), m)
    m.mul_(b1).add_(g32, alpha=1 - b1)
    v.mul_(b2).addcmul_(g32, g32, value=1 - b2)
    step = torch.div(m, b1c, out=g32)
    den = torch.div(v, b2c).sqrt_().add_(eps)
    step.div_(den)
    del den
    step = laid_out_as(step, p)
    if p.ndim >= 2:  # decoupled weight decay on matrices only
        step.add_(p, alpha=weight_decay)
    # p - lr * step in f32, then rounded to the param dtype
    p.copy_(step.mul_(lr).neg_().add_(p))


def _inner(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """The contiguous tensor whose elements ``g`` repeats over its leading
    stride-0 dims, each element ``i`` of ``p`` reading ``inner[i % n]``."""
    if tuple(g.shape) != tuple(p.shape):
        raise ValueError(f"adamw kernel wants g shaped like p {tuple(p.shape)}, "
                         f"got {tuple(g.shape)}")
    inner = g
    while inner.dim() > 0 and inner.shape[0] > 0 and inner.stride(0) == 0:
        inner = inner[0]
    if not inner.is_contiguous():
        raise ValueError("adamw kernel takes a contiguous g, or one broadcast "
                         "over leading dims from a contiguous tensor")
    return inner


def _check(g, p, m, v, scalars) -> Tuple[torch.Tensor, bool]:
    for name, t in (("g", g), ("p", p)):
        if t.dtype not in KINDS:
            raise TypeError(f"adamw kernel has no {t.dtype} path for {name}")
    for name, t in (("m", m), ("v", v)):
        if t.dtype != torch.float32:
            raise TypeError(f"adamw kernel wants f32 {name}, got {t.dtype}")
        if tuple(t.shape) != tuple(p.shape) or not t.is_contiguous():
            raise ValueError(f"adamw kernel wants a contiguous {name} shaped "
                             f"like p {tuple(p.shape)}")
    if not p.is_contiguous():
        raise ValueError("adamw kernel wants a contiguous p")
    for t in scalars:
        if t.dtype != torch.float32 or t.numel() != 1:
            raise TypeError(f"adamw kernel wants 0-d f32 step scalars, got "
                            f"{t.dtype} {tuple(t.shape)}")
    inner = _inner(g, p)
    tensors = (g, p, m, v) + tuple(scalars)
    if not all(t.is_cuda for t in tensors):
        raise ValueError(f"adamw kernel needs CUDA tensors, got "
                         f"{sorted({str(t.device) for t in tensors})}")
    if len({t.device for t in tensors}) != 1:
        raise ValueError("adamw kernel wants every operand on one card")
    vec = (all(t.data_ptr() % 16 == 0 for t in (inner, p, m, v))
           and inner.numel() % _GROUP == 0)
    return inner, vec


def launch(g: torch.Tensor, p: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
           scale: torch.Tensor, lr: torch.Tensor, b1c: torch.Tensor,
           b2c: torch.Tensor, *, b1: float, b2: float, eps: float,
           weight_decay: float) -> None:
    """The step over CUDA tensors, by the kernel: one launch, nothing
    allocated."""
    global launches
    inner, vec = _check(g, p, m, v, (scale, lr, b1c, b2c))
    if p.numel() == 0:
        return
    fn = _build.function(
        "adamw", "rt_adamw",
        [ctypes.c_void_p] * 8 + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 2
        + [ctypes.c_float] * 6 + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    with _build.device_scope(p):
        stream = torch.cuda.current_stream(p.device).cuda_stream
        err = fn(inner.data_ptr(), p.data_ptr(), m.data_ptr(), v.data_ptr(),
                 scale.data_ptr(), lr.data_ptr(), b1c.data_ptr(),
                 b2c.data_ptr(), p.numel(), inner.numel(),
                 KINDS.index(g.dtype), KINDS.index(p.dtype), b1, 1 - b1, b2,
                 1 - b2, eps, weight_decay, int(p.ndim >= 2),
                 _GROUP if vec else 1, stream)
    _build.check(err, "adamw launch")
    with _count_lock:
        launches += 1
