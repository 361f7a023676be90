"""The cross-rank gradient exchange of the port, on 2 gloo ranks.

Two processes (``torch.multiprocessing`` spawn, a file rendezvous under
``tmp_path``) each hold one pod's slab of the pod dimension and call
``compressed_grad_mean(..., group=)`` and ``make_compressed_train_step(...,
group=)``; the results are held, byte for byte, to the single-process
2-pod call on the CPU, whose plain kernels (``ops.block_topk`` /
``ops.block_scatter`` on CPU tensors) ``tests/test_torch_grad_compress.py``
holds to the reference's ``kref`` versions:

* each rank's mean, its slab of the new residuals, and the gathered
  payload equal the single-process call's; ``sent_bytes`` equals the bytes
  of the gathered payload (int32 ids and f32 blocks of both pods), and
  ``dense_bytes`` those of both pods' f32 gradients;
* three compressed train steps per rank (reduced configs in f32) equal
  the single-process run's pod ``r``: params, moments, residuals, counts
  and the metrics.
"""

import dataclasses
import datetime
import os

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro_torch.models import get_arch
from repro_torch.train import grad_compress as gc
from repro_torch.train import optimizer as opt
from repro_torch.train import trainer
from repro_torch.tree import leaves, tree_map

WORLD = 2
RATIO = 0.25
ARCHS = ["granite-3-8b", "zamba2-2.7b"]
OCFG = dict(lr=1e-2, warmup_steps=2, total_steps=50, grad_clip=1.0)
JOIN_S = 240
# ragged leaves (the kernels mask the tile edge), a 1-D leaf and a 3-D one
SHAPES = {"a": (37, 300), "b": {"c": (129,), "d": (4, 9, 260)},
          "e": (8, 128)}


def grads_tree(seed):
    """Per-pod f32 gradients and residuals, (WORLD, ...) each."""
    gen = torch.Generator().manual_seed(seed)

    def make(shape):
        return torch.randn((WORLD,) + shape, generator=gen)
    def tree(spec):
        return ({k: tree(v) for k, v in spec.items()} if isinstance(spec, dict)
                else make(spec))
    return tree(SHAPES), tree_map(lambda g: g * 0.1, tree(SHAPES))


def batches(cfg, seed):
    """Three (WORLD, 2, 16) token batches with next-token labels."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(3):
        tok = rng.integers(0, cfg.vocab_size, (WORLD * 2, 16)).astype(np.int32)
        lab = np.concatenate([tok[:, 1:], np.full((WORLD * 2, 1), -1,
                                                  np.int32)], 1)
        out.append({"tokens": torch.as_tensor(tok).reshape(WORLD, 2, 16),
                    "labels": torch.as_tensor(lab).reshape(WORLD, 2, 16)})
    return out


def cfg_of(name):
    return dataclasses.replace(get_arch(name).reduced(), dtype="float32")


def init(name):
    return trainer.init_compressed_state(
        cfg_of(name), torch.Generator().manual_seed(5), WORLD, device="cpu")


def slab(tree, r):
    return tree_map(lambda t: t[r:r + 1].clone(), tree)


def state_slab(state, r):
    """Rank ``r``'s slab of a compressed state (the 0-d counts shared)."""
    return state._replace(
        params=slab(state.params, r), residual=slab(state.residual, r),
        opt=state.opt._replace(m=slab(state.opt.m, r), v=slab(state.opt.v, r)))


def run_steps(state, name, group, rank=None):
    """Three compressed steps; returns [(state as host tensors, metrics)]."""
    step = trainer.make_compressed_train_step(cfg_of(name),
                                              opt.OptConfig(**OCFG),
                                              ratio=RATIO, group=group)
    out = []
    for b in batches(cfg_of(name), 6):
        if rank is not None:
            b = {k: v[rank:rank + 1] for k, v in b.items()}
        state, m = step(state, b)
        out.append((tree_map(torch.clone, state),
                    {k: torch.as_tensor(v).clone() for k, v in m.items()}))
    return out


def rank_main(rank, init_file, out_dir):
    """One rank: the exchange and the train steps on its slab."""
    import torch.distributed as dist
    torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=WORLD, rank=rank,
                            timeout=datetime.timedelta(seconds=JOIN_S))
    try:
        group = dist.group.WORLD
        g, r = grads_tree(1)
        mean, new_r, stats = gc.compressed_grad_mean(
            slab(g, rank), slab(r, rank), ratio=RATIO, with_payload=True,
            group=group)
        steps = {name: run_steps(state_slab(init(name), rank), name, group, rank)
                 for name in ARCHS}
        torch.save({"mean": mean, "residual": new_r, "stats": stats,
                    "steps": steps}, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Each rank's results of one 2-rank gloo run."""
    d = tmp_path_factory.mktemp("exchange")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=rank_main,
                         args=(r, str(d / "rendezvous"), str(d)))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(timeout=JOIN_S)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    assert [p.exitcode for p in procs] == [0] * WORLD
    return [torch.load(d / f"rank{r}.pt", weights_only=False)
            for r in range(WORLD)]


def assert_same_bytes(got, want, what):
    g, w = leaves(got), leaves(want)
    assert [n for n, _ in g] == [n for n, _ in w], what
    bad = [n for (n, a), (_, b) in zip(g, w)
           if not (a.dtype == b.dtype and a.shape == b.shape
                   and torch.equal(a.view(torch.uint8) if a.ndim else a,
                                   b.view(torch.uint8) if b.ndim else b))]
    assert not bad, (what, bad)


def test_mean_and_residual_slabs_equal_the_single_process_call(ranks):
    g, r = grads_tree(1)
    mean, new_r, stats = gc.compressed_grad_mean(g, r, ratio=RATIO,
                                                 with_payload=True)
    for rank, got in enumerate(ranks):
        assert_same_bytes(got["mean"], mean, f"rank {rank} mean")
        assert_same_bytes(got["residual"], slab(new_r, rank),
                          f"rank {rank} residual")
        for path, (ids, blocks) in stats["payload"].items():
            gids, gblocks = got["stats"]["payload"][path]
            assert torch.equal(gids, ids) and torch.equal(gblocks, blocks), path


def test_sent_bytes_equal_the_gathered_payload(ranks):
    g, _ = grads_tree(1)
    dense = sum(t.numel() * 4 for _, t in leaves(g))
    _, _, single = gc.compressed_grad_mean(g, grads_tree(1)[1], ratio=RATIO)
    for got in ranks:
        st = got["stats"]
        gathered = sum(ids.numel() * ids.element_size()
                       + blocks.numel() * blocks.element_size()
                       for ids, blocks in st["payload"].values())
        assert st["sent_bytes"] == gathered == single["sent_bytes"]
        assert st["dense_bytes"] == dense == single["dense_bytes"]
        assert all(ids.shape[0] == WORLD and ids.dtype == torch.int32
                   for ids, _ in st["payload"].values())


@pytest.mark.parametrize("name", ARCHS)
def test_three_train_steps_equal_the_single_process_pods(ranks, name):
    single = run_steps(init(name), name, None)
    for rank, got in enumerate(ranks):
        for i, ((state, m), (want_state, want_m)) in enumerate(
                zip(got["steps"][name], single)):
            assert_same_bytes(state, state_slab(want_state, rank),
                              f"{name} rank {rank} step {i + 1}")
            assert m.keys() == want_m.keys()
            for k in m:
                assert torch.equal(m[k], want_m[k]), (name, rank, i + 1, k)
