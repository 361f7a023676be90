"""The port's spans (``repro_torch.obs``) on the CPU: off, a step opens no
``record_function``, records no CUDA event or span and adds no autograd
node; on (a profiler records, or ``obs.enable()``), the train steps'
spans nest as the program opens them, carry their step, mark the
checkpointed super-blocks' recompute, and land in the profiler's chrome
trace; tracing changes no gradient and no state, bit for bit."""

import dataclasses
import json
from collections import Counter

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.core import DeltaTensorStore
from repro_torch.data.pipeline import write_token_dataset
from repro_torch.data.stream import StreamLoader
from repro_torch.lake import InMemoryObjectStore
from repro_torch.models import get_arch, transformer
from repro_torch.train import optimizer as opt
from repro_torch.train import trainer
from repro_torch.tree import leaves, rebuild

OCFG = opt.OptConfig(lr=1e-2, warmup_steps=2, total_steps=50)
PARENT = {"train.forward": "train.step", "train.backward": "train.step",
          "optimizer.update": "train.step", "compress": "train.step",
          "train.loss": "train.forward",
          "train.loss.backward": "train.backward",
          "compress.select": "compress"}


@pytest.fixture(autouse=True)
def _clean_records():
    obs.enable(False)
    obs.reset()
    yield
    obs.enable(False)
    obs.reset()


def tiny(policy="nothing_saveable"):
    return dataclasses.replace(get_arch("granite-3-8b").reduced(),
                               dtype="float32", remat_policy=policy)


def batch(seed=0, b=2, t=16):
    tok = torch.from_numpy(np.random.default_rng(seed).integers(0, 512, (b, t)))
    return {"tokens": tok, "labels": torch.roll(tok, -1, 1)}


def plain_run(cfg, steps=1):
    state = trainer.init_state(cfg, torch.Generator().manual_seed(0), device="cpu")
    step = trainer.make_train_step(cfg, OCFG)
    for i in range(steps):
        state, _ = step(state, batch(i))
    return state


def compressed_run(cfg, steps=1):
    state = trainer.init_compressed_state(cfg, torch.Generator().manual_seed(0), 1,
                                          device="cpu")
    step = trainer.make_compressed_train_step(cfg, OCFG, ratio=0.25)
    for i in range(steps):
        state, _ = step(state, {k: v[None] for k, v in batch(i).items()})
    return state


def graph_names(root):
    """Names of every autograd node reachable from ``root``."""
    seen, todo, out = set(), [root], []
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        out.append(type(node).__name__)
        todo.extend(n for n, _ in node.next_functions)
    return out


def test_off_a_step_opens_nothing(monkeypatch):
    calls = Counter()

    def counting(key, orig):
        def f(*a, **kw):
            calls[key] += 1
            return orig(*a, **kw)
        return f

    monkeypatch.setattr(torch.profiler, "record_function",
                        counting("record_function", torch.profiler.record_function))
    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        counting("record_function", torch.autograd.profiler.record_function))
    monkeypatch.setattr(torch.cuda, "Event", counting("event", torch.cuda.Event))
    for fn in (obs._OpenInBackward, obs._CloseInBackward):
        monkeypatch.setattr(fn, "apply", counting("node", fn.apply))
    assert not obs.on()
    plain_run(tiny())
    compressed_run(tiny())
    assert calls == Counter() and obs.spans() == []


def test_off_the_loss_graph_holds_no_marker_and_on_holds_two():
    cfg = tiny()
    params = transformer.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    flat = [p.detach().requires_grad_() for _, p in leaves(params)]
    p = rebuild(params, iter(flat))
    markers = ("_OpenInBackwardBackward", "_CloseInBackwardBackward")
    off = graph_names(transformer.loss_fn(p, cfg, batch())[0].grad_fn)
    obs.enable()
    on = graph_names(transformer.loss_fn(p, cfg, batch())[0].grad_fn)
    assert not set(markers) & set(off)
    assert Counter(on) - Counter(off) == Counter(markers)


def _by_id():
    return {s.id: s for s in obs.spans()}


def _check_nesting(n_layers):
    spans, by_id = obs.spans(), _by_id()
    steps = [s for s in spans if s.name == "train.step"]
    assert [s.step for s in steps] == list(range(1, len(steps) + 1))
    for s in spans:
        parent = by_id.get(s.parent)
        if s.name == "train.step":
            assert parent is None
            continue
        if s.name == "model.superblock":
            want = "train.backward" if s.backward else "train.forward"
        else:
            want = PARENT[s.name]
        assert parent is not None and parent.name == want, s
        assert s.step == parent.step
        assert s.start_ns >= parent.start_ns and s.end_ns <= parent.end_ns, s
    for st in steps:
        mine = Counter((s.name, s.backward) for s in spans if s.step == st.step)
        assert mine[("model.superblock", False)] == n_layers
        assert mine[("model.superblock", True)] == n_layers
        assert mine[("train.loss.backward", True)] == 1
        assert mine[("train.loss", False)] == 1
        assert {name for name, b in mine if b} == {"model.superblock",
                                                  "train.loss.backward"}


def test_spans_nest_under_a_profiler_and_land_in_its_trace(tmp_path):
    cfg = tiny()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        plain_run(cfg, steps=2)
        compressed_run(cfg, steps=1)
    assert not obs.on()
    _check_nesting(cfg.n_layers)
    names = Counter(s.name for s in obs.spans())
    assert names["train.step"] == 3 and names["compress"] == 1
    assert names["compress.select"] == len(leaves(transformer.init_params(
        cfg, device="meta")))
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    annotated = Counter(e["name"] for e in events
                        if e.get("cat") == "user_annotation"
                        and e["name"].startswith(obs.PREFIX))
    assert annotated == Counter(obs.PREFIX + s.name for s in obs.spans())


def test_spans_record_after_enable_and_stop_after_disable():
    obs.enable()
    assert obs.on()
    plain_run(tiny())
    n = len(obs.spans())
    assert n > 0 and all(s.device_ms() == s.host_ms() >= 0 for s in obs.spans())
    obs.enable(False)
    plain_run(tiny())
    assert len(obs.spans()) == n


@pytest.mark.parametrize("policy", ["nothing_saveable", "dots_saveable"])
@pytest.mark.parametrize("compressed", [False, True], ids=["plain", "compressed"])
def test_tracing_changes_no_gradient_or_state(policy, compressed):
    cfg = tiny(policy)
    run = compressed_run if compressed else plain_run
    params = transformer.init_params(cfg, torch.Generator().manual_seed(1), device="cpu")

    def grads():
        return trainer._grads(lambda p: transformer.loss_fn(p, cfg, batch()),
                              params)[2]

    off_g, off_state = grads(), run(cfg, steps=2)
    obs.enable()
    on_g, on_state = grads(), run(cfg, steps=2)
    assert obs.spans()
    for (n, a), (_, b) in zip(leaves(off_g) + leaves(off_state),
                              leaves(on_g) + leaves(on_state)):
        assert torch.equal(a, b), n


def test_loader_next_belongs_to_the_step_that_takes_the_batch():
    store = DeltaTensorStore(InMemoryObjectStore(), "ts", device="cpu")
    tid = write_token_dataset(store, np.arange(8 * 17, dtype=np.int32).reshape(8, 17))
    loader = StreamLoader(store, tid, batch_size=2, seed=0, window=2, device="cpu")
    cfg = tiny()
    state = trainer.init_state(cfg, torch.Generator().manual_seed(0), device="cpu")
    step = trainer.make_train_step(cfg, OCFG)
    obs.enable()
    it = iter(loader)
    for _ in range(2):
        data = next(it)["data"].long()
        state, _ = step(state, {"tokens": data[:, :16], "labels": data[:, 1:]})
    loader.close()
    nexts = [s for s in obs.spans() if s.name == "loader.next"]
    assert [s.step for s in nexts] == [1, 2]
    assert all(s.parent is None and s._events is None for s in nexts)
    steps = {s.step: s for s in obs.spans() if s.name == "train.step"}
    assert all(s.end_ns <= steps[s.step].start_ns for s in nexts)


def test_records_are_bounded_and_reset(monkeypatch):
    monkeypatch.setattr(obs, "_records", obs.collections.deque(maxlen=3))
    obs.enable()
    for i in range(5):
        with obs.span(f"s{i}"):
            pass
    assert [s.name for s in obs.spans()] == ["s2", "s3", "s4"]
    assert [s.step for s in obs.spans()] == [1, 1, 1]
    with obs.step():
        with obs.span("inner") as inner:
            pass
    assert inner.step == 1 and obs.spans()[-1].name == "train.step"
    with obs.span("after"):
        pass
    assert obs.spans()[-1].step == 2
    obs.reset()
    assert obs.spans() == []
