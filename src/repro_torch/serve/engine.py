"""Serving engine: one-lane prefill + batched decode with continuous slot
batching, the port of ``repro.serve.engine``.

Slots are fixed. A finished sequence frees its slot, and the engine at once
prefills the next queued request on a 1-lane cache and splices that lane
into the slot, leaf by leaf: the batch axis of a stacked cache leaf is the
first axis where the lane's shape differs, and the splice is one copy into
that axis's slot (a lane whose shapes all equal the cache's, with one slot,
replaces it). Decode is one batched step for every slot, whatever the
request boundaries, with per-slot cache lengths, and one host sync per
step (the argmax). Token ids and lengths reach the card through pinned
buffers without a sync of their own.

The ``vlm`` and ``audio`` families take their stub frontends' outputs as
``extra_inputs`` ({"image_embeds"} or {"encoder_frames"}, (rows, n, D)
each), as the reference does: a prefill gets row 0 of each, whatever the
slot, and a decode step rows ``[:n_slots]``. An audio engine given
``encoder_frames`` encodes them again at every decode step.

Weights live in the store as one FTSF tensor per param leaf, managed
through :class:`~repro_torch.serve.repo.ModelRepo`
(``store.models(prefix)``). The free functions :func:`save_weights` /
:func:`load_weights` are deprecated shims over that handle, as in the
reference.
"""

from __future__ import annotations

import queue
import warnings
import weakref
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..core.store import DeltaTensorStore
from ..lake.io import ReadExecutor
from ..models import transformer
from ..models.config import ArchConfig
from ..tree import leaves, rebuild
from .repo import ModelRepo


# -- weight load/store (deprecated shims over ModelRepo) ----------------------


def save_weights(store: DeltaTensorStore, params: Any, *,
                 prefix: str = "serve_weights") -> List[str]:
    """Deprecated: use ``store.models(prefix).save(params)``."""
    warnings.warn(
        "save_weights is deprecated; use store.models(prefix).save(params)",
        DeprecationWarning, stacklevel=2)
    with store.models(prefix) as repo:
        return repo.save(params)


def load_weights(store: DeltaTensorStore, template: Any, *,
                 prefix: str = "serve_weights",
                 io: Optional[ReadExecutor] = None) -> Any:
    """Deprecated: use ``store.models(prefix).load(template)`` (onto the
    store's device)."""
    warnings.warn(
        "load_weights is deprecated; use store.models(prefix).load(template)",
        DeprecationWarning, stacklevel=2)
    with store.models(prefix) as repo:
        return repo.load(template, io=io)


@dataclass
class Request:
    """One generation request and its output tokens."""

    rid: int
    prompt: np.ndarray            # (T,) int32
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    out_tokens: List[int] = field(default_factory=list)
    done: bool = False


class ServeEngine:
    """Continuous-batching inference engine over store-resident weights.

    Runs on the device of the params. ``close()`` /
    context-manager exit / garbage collection release the engine's
    resources, in particular the snapshot lease of a weight repo passed as
    ``repo=`` (or via :meth:`from_repo`), which the engine then owns.
    """

    def __init__(self, params, cfg: ArchConfig, *, n_slots: int, max_len: int,
                 extra_inputs: Optional[Dict[str, Any]] = None,
                 enc_len: int = 1, repo: Optional[ModelRepo] = None):
        self.params = params
        self.cfg = cfg
        self.n_slots = n_slots
        self.max_len = max_len
        self.enc_len = enc_len
        self.extra = extra_inputs or {}
        self.device = leaves(params)[0][1].device
        self.caches = transformer.init_caches(cfg, n_slots, max_len,
                                              enc_len=enc_len,
                                              device=self.device)
        self.slot_req: List[Optional[Request]] = [None] * n_slots
        self.slot_len = np.zeros(n_slots, np.int32)
        self.queue: "queue.Queue[Request]" = queue.Queue()
        pin = self.device.type == "cuda"
        # host side of each step's upload; a buffer is rewritten only after
        # the step's argmax sync, when its copy has landed
        self._tok_host = torch.zeros((n_slots, 1), dtype=torch.long,
                                     pin_memory=pin)
        self._len_host = torch.zeros((n_slots,), dtype=torch.int32,
                                     pin_memory=pin)
        # GC backstop: a dropped engine must not pin its weight snapshot
        self._finalizer = (weakref.finalize(self, repo.close)
                           if repo is not None
                           else weakref.finalize(self, lambda: None))

    # -- lifecycle -------------------------------------------------------------

    @classmethod
    def from_repo(cls, repo: ModelRepo, template: Any, cfg: ArchConfig, *,
                  n_slots: int, max_len: int, **kwargs) -> "ServeEngine":
        """Build an engine whose weights load from ``repo`` onto its
        store's device (one merged fetch plan); the engine owns the handle
        and releases its snapshot lease on ``close()``."""
        params = repo.load(template)
        return cls(params, cfg, n_slots=n_slots, max_len=max_len, repo=repo,
                   **kwargs)

    def close(self) -> None:
        """Release engine resources (idempotent): drop queued and in-slot
        requests and release the owned weight repo's snapshot lease."""
        self.slot_req = [None] * self.n_slots
        self.slot_len[:] = 0
        while not self.queue.empty():
            try:
                self.queue.get_nowait()
            except queue.Empty:  # pragma: no cover - racing drain
                break
        self._finalizer()

    @property
    def closed(self) -> bool:
        """Whether :meth:`close` has run (weight snapshot lease released)."""
        return not self._finalizer.alive

    def __enter__(self) -> "ServeEngine":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()

    # -- slot management -----------------------------------------------------

    def submit(self, req: Request) -> None:
        """Queue a request; it is admitted when a slot frees."""
        if self.closed:
            raise RuntimeError("engine is closed")
        self.queue.put(req)

    def _admit(self) -> None:
        for s in range(self.n_slots):
            if self.slot_req[s] is not None or self.queue.empty():
                continue
            req = self.queue.get()
            t = len(req.prompt)
            # single-request prefill on a 1-lane cache, spliced into slot s
            lane = transformer.init_caches(self.cfg, 1, self.max_len,
                                           enc_len=self.enc_len,
                                           device=self.device)
            tok = torch.as_tensor(np.asarray(req.prompt, np.int64)[None]
                                  ).to(self.device)
            extra = {k: v[:1] for k, v in self.extra.items()}
            logits, lane, _ = transformer.prefill(self.params, self.cfg, tok,
                                                  lane, **extra)
            req.out_tokens.append(int(logits[0, -1].argmax()))
            self.caches = rebuild(self.caches, iter([
                self._splice(full, one, s) for (_, full), (_, one)
                in zip(leaves(self.caches), leaves(lane))]))
            self.slot_req[s] = req
            # cache holds t entries; the pending token writes at index t
            self.slot_len[s] = t

    def _splice(self, full: torch.Tensor, one: torch.Tensor,
                s: int) -> torch.Tensor:
        """The cache leaf ``full`` with the 1-lane leaf ``one`` in slot
        ``s``, written in place: the batch axis is the first axis where
        the shapes differ (stacked leaves carry leading layer axes). A lane
        of the same shape replaces the leaf with one slot (and is dropped
        with several, as in the reference)."""
        if full.shape == one.shape:
            return one if self.n_slots == 1 else full
        axis = next(d for d in range(full.ndim)
                    if full.shape[d] != one.shape[d])
        full.narrow(axis, s, 1).copy_(one)
        return full

    # -- decode loop -----------------------------------------------------------

    def step(self) -> int:
        """One engine iteration: admit, decode all active slots, retire."""
        self._admit()
        active = [s for s in range(self.n_slots) if self.slot_req[s] is not None]
        if not active:
            return 0
        tok = self._tok_host.numpy()
        tok[:] = 0
        for s in active:
            tok[s, 0] = self.slot_req[s].out_tokens[-1]
        self._len_host.numpy()[:] = self.slot_len
        self.caches["index"] = self._len_host.to(self.device, non_blocking=True)
        logits, self.caches, _ = transformer.decode_step(
            self.params, self.cfg,
            self._tok_host.to(self.device, non_blocking=True), self.caches,
            **{k: v[:self.n_slots] for k, v in self.extra.items()})
        nxt = logits[:, 0].argmax(dim=-1).cpu().numpy()  # the step's sync
        for s in active:
            req = self.slot_req[s]
            req.out_tokens.append(int(nxt[s]))
            self.slot_len[s] += 1
            hit_eos = req.eos_id is not None and int(nxt[s]) == req.eos_id
            if (len(req.out_tokens) >= req.max_new_tokens or hit_eos
                    or self.slot_len[s] >= self.max_len - 1):
                req.done = True
                self.slot_req[s] = None
                self.slot_len[s] = 0
        return len(active)

    def run_until_drained(self, max_iters: int = 10_000) -> None:
        """Step until the queue and every slot are empty."""
        for _ in range(max_iters):
            if self.step() == 0 and self.queue.empty():
                return
        raise RuntimeError("serve loop did not drain")
