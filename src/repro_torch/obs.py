"""The port's spans: named intervals of the program's own layers.

    with obs.span("train.forward"):
        ...

A span is on only while a torch profiler records
(``torch.autograd._profiler_enabled()``) or after :func:`enable`. Off, a
span costs one flag check: it opens no ``record_function``, records no
CUDA event, keeps no record and inserts no autograd node. On, it

* opens ``record_function("repro_torch." + name)``, so it lands in the
  profiler's chrome trace on the device trace's clock (the trace is the
  exporter: this module writes no file);
* keeps a :class:`Span` record: its name, its parent, the step it belongs
  to, its thread, whether a backward pass ran it (a checkpointed block's
  recompute), ``time.time_ns()`` at its start and end, and on a card a
  pair of timing events on the current stream, read only at read-out
  (:meth:`Span.device_ms`): nothing inside a step waits for the card.

A span's parent is the innermost span open on its thread or, where its
thread has none (autograd's device threads run a card's backward pass),
the innermost open on any thread. :func:`step` numbers the steps; a span
outside any step carries the number of the step that opens next (the
loader's batch belongs to the step that takes it). Records are kept in
a bounded buffer (the oldest dropped first) until :func:`reset`.

The names the program opens, in order from a step down: ``train.step``,
``loader.next`` (host time only), ``train.forward``, ``model.superblock``,
``train.loss``, ``train.backward``, ``train.loss.backward``,
``compress``, ``compress.select``, ``optimizer.update``.
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time
from typing import Callable, List, Optional, Tuple

import torch

PREFIX = "repro_torch."
CAPACITY = 1 << 16   # records kept; the oldest go first

_enabled = False
_lock = threading.Lock()
_records: collections.deque = collections.deque(maxlen=CAPACITY)
_open: List["Span"] = []
_last_id = 0
_last_step = 0
_step_open: Optional[int] = None


def on() -> bool:
    """Whether spans record: a torch profiler is recording, or
    :func:`enable` was called."""
    return _enabled or torch.autograd._profiler_enabled()


def enable(flag: bool = True) -> None:
    """Record spans without a profiler (``enable(False)`` undoes it)."""
    global _enabled
    _enabled = bool(flag)


def reset() -> None:
    """Drop every record and restart the step numbers."""
    global _last_step, _step_open
    with _lock:
        _records.clear()
        _open.clear()
        _last_step, _step_open = 0, None


def spans() -> List["Span"]:
    """The closed spans kept, oldest first."""
    with _lock:
        return list(_records)


class Span:
    """One span's record. ``device_ms()`` reads its device interval."""

    __slots__ = ("name", "id", "parent", "step", "thread", "backward",
                 "start_ns", "end_ns", "_events", "_rf")

    def __init__(self, name: str, device: bool):
        self.name = name
        self.thread = threading.get_ident()
        self.backward = torch._C._current_graph_task_id() != -1
        self.end_ns: Optional[int] = None
        self._rf = torch.profiler.record_function(PREFIX + name)
        self._rf.__enter__()
        self._events: Optional[Tuple] = None
        if device and torch.cuda.is_initialized():
            self._events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
            self._events[0].record()
        self.start_ns = time.time_ns()

    def _close(self) -> None:
        self.end_ns = time.time_ns()
        if self._events is not None:
            self._events[1].record()
        self._rf.__exit__(None, None, None)
        self._rf = None

    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6

    def device_ms(self) -> float:
        """The card's time from the span's start to its end on the stream
        it opened on (waits for its end event); the host duration where no
        event was recorded (CPU work is synchronous)."""
        if self._events is None:
            return self.host_ms()
        self._events[1].synchronize()
        return self._events[0].elapsed_time(self._events[1])

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, id={self.id}, parent={self.parent}, "
                f"step={self.step}, backward={self.backward})")


def _open_span(name: str, *, device: bool = True) -> Optional[Span]:
    """Open ``name`` where spans record (None where they do not); close it
    with :func:`_close_span`, on the same thread. ``device=False`` keeps
    host time only."""
    global _last_id
    if not on():
        return None
    s = Span(name, device)
    with _lock:
        _last_id += 1
        s.id = _last_id
        s.step = _last_step + 1 if _step_open is None else _step_open
        mine = [o for o in _open if o.thread == s.thread]
        parent = mine[-1] if mine else (_open[-1] if _open else None)
        s.parent = None if parent is None else parent.id
        _open.append(s)
    return s


def _close_span(s: Optional[Span]) -> None:
    if s is None:
        return
    s._close()
    with _lock:
        if s in _open:
            _open.remove(s)
        _records.append(s)


class _Context:
    __slots__ = ("name", "device", "is_step", "s")

    def __init__(self, name: str, device: bool, is_step: bool):
        self.name, self.device, self.is_step = name, device, is_step

    def __enter__(self):
        global _last_step, _step_open
        if self.is_step:
            with _lock:
                _last_step += 1
                _step_open = _last_step
        self.s = _open_span(self.name, device=self.device)
        return self.s

    def __exit__(self, *exc):
        global _step_open
        _close_span(self.s)
        if self.is_step:
            _step_open = None
        return False


_OFF = contextlib.nullcontext()


def span(name: str, *, device: bool = True):
    """The span ``name`` around a ``with`` block (``device=False`` keeps
    host time only); the block gets its :class:`Span`, or None where spans
    do not record."""
    if not on():
        return _OFF
    return _Context(name, device, False)


def step():
    """The span ``train.step`` around one train step, which numbers it."""
    if not on():
        return _OFF
    return _Context("train.step", True, True)


# -- a span over a stretch of the backward pass ---------------------------------

class _Holder:
    __slots__ = ("name", "s")

    def __init__(self, name: str):
        self.name, self.s = name, None


class _OpenInBackward(torch.autograd.Function):
    """Identity on the output of a stretch; its backward opens the span."""

    @staticmethod
    def forward(ctx, x, holder):
        ctx.holder = holder
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        ctx.holder.s = _open_span(ctx.holder.name)
        return g, None


class _CloseInBackward(torch.autograd.Function):
    """Identity on the input of a stretch; its backward closes the span."""

    @staticmethod
    def forward(ctx, x, holder):
        ctx.holder = holder
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        _close_span(ctx.holder.s)
        ctx.holder.s = None
        return g, None


def _same(x):
    return x


def backward_span(name: str, x: torch.Tensor
                  ) -> Tuple[torch.Tensor, Callable[[torch.Tensor], torch.Tensor]]:
    """``(x', mark)`` for a stretch of the forward pass from ``x`` to an
    output ``y``: compute from ``x'`` and return ``mark(y)``, and the
    backward pass from ``y``'s gradient to ``x``'s runs inside the span
    ``name``. Both are identities. Where spans do not record, autograd
    does not record, or ``x`` is a tensor subclass (a DTensor), ``x`` comes
    back as it is and ``mark`` does nothing."""
    if (not on() or type(x) is not torch.Tensor or not x.requires_grad
            or not torch.is_grad_enabled()):
        return x, _same
    holder = _Holder(name)
    return (_CloseInBackward.apply(x, holder),
            lambda y: _OpenInBackward.apply(y, holder))
