"""Three training steps of the reference: loss and gradients of
:func:`.model.loss`, the BSGS compressor with error feedback for a
compressed step, then AdamW, with the parameters stored in the
configuration's dtype between steps.

The optimizer is the configuration's: clip by the global norm in f32,
Adam's moments in f32, bias correction, decoupled weight decay on leaves
of two or more dimensions (counted on the state's leaves, which carry the
pod dimension in a compressed step), a linear warmup and a cosine decay of
the learning rate. A compressed step selects, in each leaf viewed as 2-D
and cut into (bh, bw) tiles, the k = max(1, floor(tiles x ratio)) tiles of
largest sum of squares of e = g + r (ties to the lower tile id), sends
them, and keeps e less what it sent as the next residual; with one pod the
mean of the decoded payloads is its own.
"""

from __future__ import annotations

import math
import time
from typing import Dict, List, Sequence, Tuple

import torch

from ..wire import blocks_sent, leaf_geometry
from . import model


def lr_at(o: dict, count: int) -> float:
    """The learning rate of update ``count`` (1 for the first)."""
    warm = min(count / max(o["warmup_steps"], 1), 1.0)
    prog = min(max((count - o["warmup_steps"])
                   / max(o["total_steps"] - o["warmup_steps"], 1), 0.0), 1.0)
    cos = 0.5 * (1 + math.cos(math.pi * prog))
    return o["lr"] * warm * (o["min_lr_ratio"] + (1 - o["min_lr_ratio"]) * cos)


ROWS = 1 << 13     # rows of a 2-D leaf handled at a time (a multiple of bh)


def tiles(x2: torch.Tensor, bh: int, bw: int) -> torch.Tensor:
    """(gh, bh, gw, bw) view of 2-D ``x2`` padded with zeros to whole tiles."""
    m, n = x2.shape
    gh, gw = -(-m // bh), -(-n // bw)
    if (gh * bh, gw * bw) != (m, n):
        x2 = torch.nn.functional.pad(x2, (0, gw * bw - n, 0, gh * bh - m))
    return x2.reshape(gh, bh, gw, bw)


def _row_chunks(m: int, bh: int):
    step = max(bh, ROWS // bh * bh)
    return [(lo, min(lo + step, m)) for lo in range(0, m, step)]


def compress(e: torch.Tensor, ratio: float, block: Tuple[int, int]
             ) -> torch.Tensor:
    """What one pod sends of ``e``, decoded: e on its k tiles of largest
    energy, zero elsewhere (a new tensor; ``e`` is not changed). Works
    through the 2-D view ``ROWS`` rows at a time."""
    (m, n), (bh, bw), (gh, gw) = leaf_geometry(e.shape, block)
    k = blocks_sent(e.shape, ratio, block)
    e2 = e.reshape(m, n)
    energy = torch.cat([tiles(e2[lo:hi], bh, bw).square().sum(dim=(1, 3))
                        for lo, hi in _row_chunks(m, bh)]).reshape(-1)
    ids = torch.sort(energy, descending=True, stable=True).indices[:k]
    keep = torch.zeros(gh * gw, dtype=torch.bool, device=e.device)
    keep[ids] = True
    keep = keep.view(gh, gw)
    out = torch.empty_like(e2)
    for lo, hi in _row_chunks(m, bh):
        mask = keep[lo // bh:-(-hi // bh)].repeat_interleave(bh, 0)[:hi - lo]
        mask = mask.repeat_interleave(bw, 1)[:, :n]
        torch.mul(e2[lo:hi], mask, out=out[lo:hi])
    return out.view(e.shape)


def nonzero_tiles(x: torch.Tensor, block: Tuple[int, int]) -> int:
    """Tiles of ``x`` (2-D view, as :func:`compress` cuts it) holding any
    non-zero element."""
    (m, n), (bh, bw), _ = leaf_geometry(x.shape, block)
    x2 = x.reshape(m, n)
    return sum(int((tiles(x2[lo:hi], bh, bw) != 0).any(dim=3).any(dim=1).sum())
               for lo, hi in _row_chunks(m, bh))


def _slices(t: torch.Tensor):
    """``t`` in slices along dim 0 of about ``1 << 26`` elements (whole
    where it is smaller), for updates that keep their temporaries small."""
    if t.ndim < 2:
        return [t]
    rows = max(1, (1 << 26) // max(1, t[0].numel()))
    return t.split(rows)


def run(arch: dict, mix: dict, w0: Dict[str, torch.Tensor],
        batches: Sequence[Tuple[torch.Tensor, torch.Tensor]],
        mm: model.MM = model.matmul) -> Dict:
    """Three steps from the initial weights ``w0`` (consumed) over
    ``batches`` [(tokens, labels)]. Returns ``losses`` (per step),
    ``grad_norms`` (per leaf: the norm of the first step's gradient as the
    optimizer takes it, after compression and the clip), ``change_norms``
    (per leaf: the norm of the parameters' change after the three steps)
    and, for a compressed step, ``tiles_sent`` (per leaf: non-zero tiles of
    the first step's decoded gradient) and ``residual_norms`` (per leaf:
    the norm of the residual the first step keeps)."""
    o = mix["optimizer"]
    bsgs = mix["step"] == "bsgs"
    ratio, block = mix.get("ratio"), tuple(mix.get("block", (8, 128)))
    names = sorted(w0)
    stored = {k: w0[k].dtype for k in names}
    start = {k: w0[k] for k in names}                 # kept in its dtype
    w = {k: w0[k].to(torch.float32, copy=True) for k in names}
    # the state's leaves carry the pod dim in a compressed step
    decays = {k: w[k].ndim + int(bsgs) >= 2 for k in names}
    m = {k: torch.zeros_like(w[k]) for k in names}
    v = {k: torch.zeros_like(w[k]) for k in names}
    r = {k: torch.zeros_like(w[k]) for k in names} if bsgs else None
    losses: List[float] = []
    out: Dict = {"seconds": {"forward_backward": 0.0, "update": 0.0}}
    for step, (tokens, labels) in enumerate(batches, start=1):
        t0 = time.perf_counter()
        leaves = [w[k].requires_grad_() for k in names]
        value = model.loss(w, arch, tokens, labels, mm)
        grads = dict(zip(names, torch.autograd.grad(value, leaves)))
        losses.append(float(value.detach()))
        t1 = time.perf_counter()
        with torch.no_grad():
            for k in names:
                w[k] = w[k].detach()
            if bsgs:
                for k in names:
                    e = grads.pop(k).add_(r[k])
                    grads[k] = compress(e, ratio, block)
                    r[k] = e.sub_(grads[k])
                    del e
                if step == 1:
                    out["tiles_sent"] = {k: nonzero_tiles(grads[k], block)
                                         for k in names}
                    out["residual_norms"] = {k: float(r[k].norm())
                                             for k in names}
            norm = math.sqrt(sum(float(g.norm()) ** 2 for g in grads.values()))
            scale = min(o["grad_clip"] / max(norm, 1e-9), 1.0)
            lr = lr_at(o, step)
            b1c, b2c = 1 - o["b1"] ** step, 1 - o["b2"] ** step
            if step == 1:
                out["grad_norms"] = {k: float(grads[k].norm()) * scale
                                     for k in names}
            for k in names:
                g = grads.pop(k).mul_(scale)
                m[k].mul_(o["b1"]).add_(g, alpha=1 - o["b1"])
                v[k].mul_(o["b2"]).addcmul_(g, g, value=1 - o["b2"])
                del g
                for wk, mk, vk in zip(_slices(w[k]), _slices(m[k]), _slices(v[k])):
                    upd = (mk / b1c).div_((vk / b2c).sqrt_().add_(o["eps"]))
                    if decays[k]:
                        upd.add_(wk, alpha=o["weight_decay"])
                    # w - lr * upd, rounded to the stored dtype
                    wk.copy_(upd.mul_(-lr).add_(wk).to(stored[k]))
                    del upd
            float(w[names[-1]].view(-1)[0])     # waits for the update
        out["seconds"]["forward_backward"] += t1 - t0
        out["seconds"]["update"] += time.perf_counter() - t1
        del grads
    out["losses"] = losses
    out["change_norms"] = {k: float((w[k] - start[k].float()).norm())
                           for k in names}
    return out
