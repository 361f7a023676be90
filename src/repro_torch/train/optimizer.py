"""AdamW with a warmup-cosine schedule, the port of
``repro.train.optimizer``: the reference's formula, moments in f32 shaped
like the params.

:func:`update` writes the new moments and params into the tensors it is
given, under ``torch.no_grad()`` (the reference returns new arrays; its
production step donates the old ones). At granite-3-8b's width that saves
a second copy of the moments. The arithmetic is the reference's, not
``torch.optim.AdamW``'s (which decays before the step): clip by the global
norm in f32, the moment updates, bias correction, decoupled weight decay on
leaves of two or more dimensions only, and the result cast back to the
param dtype. Step-dependent scalars (the schedule, the bias corrections,
the clip scale) are 0-d f32 tensors on the params' device, so a step never
waits on the host.

Each leaf takes one of two routes, by what it is: a leaf on the card goes
through the fused kernel ``kernels/adamw`` (one pass over g, p, m and v);
a CPU or meta leaf, and a DTensor leaf, whose ZeRO-1 moments may lie
otherwise than its param, take the same arithmetic one op at a time
(``kernels.adamw.plain``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from .. import obs
from ..kernels import adamw, ops
from ..tree import leaves, tree_map


@dataclass(frozen=True)
class OptConfig:
    """AdamW hyper-parameters and the schedule's shape."""

    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    grad_clip: float = 1.0


class OptState(NamedTuple):
    """f32 first and second moments shaped like the params, and the 0-d
    int32 count of updates applied."""

    m: Any
    v: Any
    count: torch.Tensor


def schedule(cfg: OptConfig, step: Any) -> torch.Tensor:
    """Linear warmup to ``cfg.lr``, then a cosine down to
    ``min_lr_ratio * lr`` at ``total_steps``; f32, as a 0-d tensor."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def init(params: Any) -> OptState:
    """Zero moments for ``params``, on each leaf's device."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    device = leaves(params)[0][1].device
    return OptState(m=tree_map(zeros, params), v=tree_map(zeros, params),
                    count=torch.zeros((), dtype=torch.int32, device=device))


def _sum_squares(x: torch.Tensor) -> torch.Tensor:
    if x.ndim == 0:
        return x.float().square()
    # the f32 norm of each last-dim row, then the sum of their squares: no
    # f32 copy of the leaf (a broadcast leaf, as the compressed step passes,
    # stays unmaterialised), and no single f32 running sum over the whole
    # leaf, which torch's CPU vector_norm keeps (3 % off at 2e8 elements)
    return torch.linalg.vector_norm(x, dim=-1, dtype=torch.float32).square().sum()


def global_norm(tree: Any) -> torch.Tensor:
    """The f32 L2 norm over every leaf of ``tree``."""
    return torch.sqrt(sum(_sum_squares(x) for _, x in leaves(tree)))


@torch.no_grad()
def update(cfg: OptConfig, grads: Any, state: OptState, params: Any, *,
           grad_norm: Optional[torch.Tensor] = None
           ) -> Tuple[Any, OptState, Dict[str, torch.Tensor]]:
    """One AdamW step. ``params`` and the moments of ``state`` are updated
    in place and returned, with the new count and the metrics ``lr`` and
    ``grad_norm`` (the norm before clipping). ``grad_norm`` replaces
    ``global_norm(grads)`` where ``grads`` is one rank's slab of a larger
    tree whose norm the clip must use. DTensor leaves may be laid out
    differently from their moments (ZeRO-1): each gradient is moved to its
    moments' placements (the mesh step has done so before the call), and
    each step to its param's."""
    with obs.span("optimizer.update"):
        gnorm = global_norm(grads) if grad_norm is None else grad_norm
        scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
        count = state.count + 1
        lr = schedule(cfg, count)
        b1c = 1 - torch.pow(cfg.b1, count.to(torch.float32))
        b2c = 1 - torch.pow(cfg.b2, count.to(torch.float32))
        g_leaves, m_leaves, v_leaves = (leaves(t) for t in (grads, state.m, state.v))
        p_leaves = leaves(params)
        if not ([n for n, _ in g_leaves] == [n for n, _ in m_leaves]
                == [n for n, _ in v_leaves] == [n for n, _ in p_leaves]):
            raise ValueError("grads, moments and params differ in structure")
        hyper = dict(b1=cfg.b1, b2=cfg.b2, eps=cfg.eps,
                     weight_decay=cfg.weight_decay)
        for (_, g), (_, m), (_, v), (_, p) in zip(g_leaves, m_leaves, v_leaves,
                                                  p_leaves):
            per_op = p.device.type == "meta" or hasattr(p, "placements")
            (adamw.plain if per_op else ops.adamw)(
                g, p, m, v, scale, lr, b1c, b2c, **hyper)
        return params, OptState(m=state.m, v=state.v, count=count), {
            "lr": lr, "grad_norm": gnorm}
