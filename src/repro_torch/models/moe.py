"""Mixture-of-Experts with gather-based dispatch, the counterpart of
``repro.models.moe`` in plain PyTorch.

Routing groups are sequences: each batch row routes its T tokens on its
own, into (B, E, C) dispatch tables with
``C = moe_capacity(cfg, T)``. A token's k choices take per-(group, expert)
positions from a cumulative sum in token-major, k-minor order; positions
past C drop (standard capacity-factor behaviour). Dispatch and combine are
gathers, not one-hot matmuls. Top-k gate weights are renormalised over the
chosen experts, and the aux loss is the Shazeer load-balance loss.
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import torch
import torch.nn.functional as F

from ..dist.sharding import (constrain, current_mesh, is_dtensor, meet,
                             shard_map_batch)
from .config import ArchConfig
from .layers import Params, dense_init, normal


def moe_capacity(cfg: ArchConfig, t: int) -> int:
    """Expert capacity C for a group of ``t`` tokens."""
    c = int(math.ceil(t * cfg.top_k / cfg.n_experts * cfg.capacity_factor))
    return max(4, -(-c // 4) * 4) if t > 1 else max(1, c)


def moe_init(gen, cfg: ArchConfig, dtype, device) -> Params:
    """Router (f32) and the experts' stacked SwiGLU weights."""
    e, d, f = cfg.n_experts, cfg.d_model, cfg.expert_d_ff
    return {
        "w_router": dense_init(gen, d, e, torch.float32, device),
        "w_gate": normal((e, d, f), 1.0 / math.sqrt(d), dtype, gen, device),
        "w_up": normal((e, d, f), 1.0 / math.sqrt(d), dtype, gen, device),
        "w_down": normal((e, f, d), 1.0 / math.sqrt(f), dtype, gen, device),
    }


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last dim: the k largest values and their
    indices, equal values to the lowest index first (a stable descending
    sort; ``torch.topk`` promises no order among ties)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(p: Params, x: torch.Tensor, cfg: ArchConfig):
    """x: (B, T, D) -> (router probs (B,T,E) f32, renormalised gate weights
    (B,T,k), expert ids (B,T,k))."""
    logits = x.float() @ p["w_router"].float()
    probs = torch.softmax(logits, dim=-1)
    gate_w, gate_idx = top_k(probs, cfg.top_k)
    gate_w = gate_w / gate_w.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, gate_w, gate_idx


def _tables(gate_idx: torch.Tensor, t: int, e: int, c: int):
    """Each batch row's dispatch tables from its expert ids (B, T, k): (sel
    (B, E, C), the token of each expert slot, ``t`` (the pad row) where
    empty; pos (B, T*k), each (token, choice) slot's position in its
    expert; keep (B, T*k), pos < C)."""
    b, k = gate_idx.shape[0], gate_idx.shape[-1]
    ef = gate_idx.reshape(b, t * k)                         # token-major
    oh = F.one_hot(ef, e)                                   # (B, T*k, E)
    pos = (oh.cumsum(dim=1) * oh).sum(-1) - 1               # 0-based
    keep = pos < c
    token_of_slot = torch.arange(t, device=ef.device).repeat_interleave(k)
    target = torch.where(keep, ef * c + pos, e * c)         # e*c: dropped
    sel = torch.full((b, e * c + 1), t, dtype=torch.long, device=ef.device)
    sel.scatter_(1, target, token_of_slot.expand(b, -1))
    return sel[:, : e * c].reshape(b, e, c), pos, keep      # t: the pad row


def _gather_slots(xp: torch.Tensor, sel: torch.Tensor) -> torch.Tensor:
    """xp (B, T+1, D) rows at sel (B, E, C) -> (B, E, C, D)."""
    rows = torch.arange(xp.shape[0], device=xp.device)
    return xp[rows[:, None, None], sel]


def _gather_back(out_e: torch.Tensor, slot_e: torch.Tensor,
                 slot_c: torch.Tensor) -> torch.Tensor:
    """out_e (B, E, C, D) at each (token, choice) slot's expert and
    position (B, T*k) -> (B, T*k, D)."""
    rows = torch.arange(out_e.shape[0], device=out_e.device)
    return out_e[rows[:, None], slot_e, slot_c]


def _stationary(expert_in: torch.Tensor, w: torch.Tensor) -> bool:
    """Whether the experts run where their weights lie: under a mesh,
    where the (B, E, C, D) slot rows are fewer elements than one expert
    tensor, so moving the rows costs less than gathering the weights."""
    return current_mesh() is not None and is_dtensor(w) \
        and expert_in.numel() < w.numel()


def moe_apply(p: Params, x: torch.Tensor,
              cfg: ArchConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, T, D) -> (out (B, T, D), aux load-balance loss ()).

    Under a mesh the tables and both gathers run batch-locally on each
    rank's rows (``shard_map_batch``), and the expert tensors take the
    batch over the data axes and the experts over ``model`` (or, where E
    does not divide it, the expert FFN width: first-divisible-wins). Where
    the slot rows are fewer than an expert tensor's elements (a decode
    step) the weights stay as they lie and the rows are laid out to meet
    them (:func:`_stationary`)."""
    b, t, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    c = moe_capacity(cfg, t)
    probs, gate_w, gate_idx = route(p, x, cfg)

    # Shazeer load-balance aux loss: E * sum_e f_e * p_e
    me = probs.mean(dim=(0, 1))
    ce = F.one_hot(gate_idx[..., 0], e).float().mean(dim=(0, 1))
    aux = e * (me * ce).sum()

    sel, pos, keep = shard_map_batch(
        functools.partial(_tables, t=t, e=e, c=c), gate_idx)
    ef = gate_idx.reshape(b, t * k)

    xp = torch.cat([x, x.new_zeros((b, 1, d))], dim=1)
    expert_in = shard_map_batch(_gather_slots, xp, sel)      # (B,E,C,D)
    if _stationary(expert_in, p["w_gate"]):
        expert_in = meet(expert_in, p["w_gate"], {0: 1, 1: 3})
        h = F.silu(torch.einsum("becd,edf->becf", expert_in, p["w_gate"])) \
            * torch.einsum("becd,edf->becf", expert_in, p["w_up"])
        out_e = torch.einsum("becf,efd->becd",
                             meet(h, p["w_down"], {0: 1, 1: 3}),
                             p["w_down"])
    else:
        expert_in = constrain(expert_in, ["batch", "model", None, None])
        # the experts' weights split as the expert tensors do (E over
        # `model`, else the FFN width), so each rank's einsums need no
        # other rank's part
        w_gate, w_up = (constrain(p[name], ["model", None, "model"])
                        for name in ("w_gate", "w_up"))
        w_down = constrain(p["w_down"], ["model", "model", None])
        h = F.silu(torch.einsum("becd,edf->becf", expert_in, w_gate)) * \
            torch.einsum("becd,edf->becf", expert_in, w_up)
        h = constrain(h, ["batch", "model", None, "model"])
        out_e = constrain(torch.einsum("becf,efd->becd", h, w_down),
                          ["batch", "model", None, None])

    # combine: gather each token's k slots back, weight, sum
    slot_e = ef.clamp(0, e - 1)
    slot_c = pos.clamp(0, c - 1)
    per_slot = shard_map_batch(_gather_back, out_e, slot_e, slot_c)
    w = (keep * gate_w.reshape(b, t * k)).to(per_slot.dtype)
    out = (per_slot * w[..., None]).reshape(b, t, k, d).sum(dim=2)
    return out.to(x.dtype), aux
