"""Decode on a mesh: 4 gloo ranks against the plain decode and the reference.

Four processes (``torch.multiprocessing`` spawn, a file rendezvous under
``tmp_path``) form a (2, 2) ``("data", "model")`` mesh. For each reduced
config (f32) this process makes one seeded param tree (the reference's
``init_params``, carried across with ``params_from_numpy``), prefills 6
ragged prompts one lane at a time with the port's plain ``prefill`` and
splices the lanes into 6 slots, as the serving engine does. Each rank
places the params by ``params_shardings`` and the caches by
``specs._cache_shardings`` (batch over ``data``; KV heads over ``model``
where they divide it, else the sequence), then runs 6 ``decode_step`` calls
on seeded tokens through the dry run's serve wrapper, and gathers the
logits and caches.

Cases: a dense arch with 1 kv head (the cache splits seq: the
flash-decode combine), the same arch with 2 (the cache splits heads), a
windowed arch with 1 kv head served from a window-sized ring cache (seq
split, the ring wrapping), a windowed MoE arch under ``fsdp_tp`` (experts
at T = 1 where their weights lie), zamba2 (hybrid: Mamba2 states and the
shared attention's caches) and xlstm (mLSTM and sLSTM states), each at 2
super-blocks. The prompts' lengths put the writes in both seq shards, one
crossing the boundary, and wrap the ring.

Held to the port's plain decode from the same caches: the index exactly;
every cache entry that no step writes byte for byte, and the written ones
at the same places; the written entries, the recurrent states and the f32
logits within 1e-5 of their max |x| (the mesh sums its projections and
the combine's softmax in another order, so a newly computed entry may
differ in its last bits). The write itself, given the same k/v, is held
byte for byte: per slot at the shard boundary and across the ring's wrap,
and a span that straddles the two shards. Held to the reference: the
JAX package's ``decode_step`` from the same caches within the
``RTOL = ATOL = 1e-4`` of ``tests/test_torch_models.py``.
"""

import dataclasses
import datetime
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro.models import get_arch as jget_arch
from repro.models import transformer as jt
from repro_torch.models import attention, get_arch
from repro_torch.models import transformer as tt
from repro_torch.tree import leaves, params_from_numpy, rebuild, to_numpy

WORLD = 4
MESH = ((2, 2), ("data", "model"))
B, STEPS = 6, 6
# name: (arch, config overrides, cache length, prompt lengths, the dim of a
# KV leaf (B, S, H, D) that `model` splits)
CASES = {
    "seq": ("granite-3-8b", {"n_kv_heads": 1}, 24, (5, 11, 12, 17, 2, 9), 1),
    "heads": ("granite-3-8b", {}, 24, (5, 11, 12, 17, 2, 9), 2),
    "ring": ("h2o-danube-3-4b", {"n_kv_heads": 1}, 16,
             (7, 13, 16, 11, 3, 8), 1),
    "moe": ("mixtral-8x22b", {}, 24, (5, 11, 12, 17, 2, 9), 2),
    "hybrid": ("zamba2-2.7b", {}, 24, (3, 5, 8, 7, 2, 8), 2),
    "ssm": ("xlstm-1.3b", {}, 24, (3, 5, 8, 7, 2, 8), None),
}
RTOL = 1e-5            # against the plain decode, of max |x|
REF_RTOL = REF_ATOL = 1e-4
JOIN_S = 400


def cfg_of(case):
    arch, kw = CASES[case][:2]
    return (dataclasses.replace(jget_arch(arch).reduced(), **kw),
            dataclasses.replace(get_arch(arch).reduced(), **kw))


def inputs_of(case):
    """(reference params, the port's params, the spliced caches after the
    ragged prefill, decode tokens (STEPS, B, 1))."""
    jcfg, cfg = cfg_of(case)
    _, _, max_len, lengths, _ = CASES[case]
    jp = jt.init_params(jcfg, jax.random.key(1))
    params = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(7)
    caches = tt.init_caches(cfg, B, max_len, device="cpu")
    for row, n in enumerate(lengths):
        lane = tt.init_caches(cfg, 1, max_len, device="cpu")
        prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, n)))
        _, lane, _ = tt.prefill(params, cfg, prompt, lane)
        for (name, full), (_, one) in zip(leaves(caches), leaves(lane)):
            if name != "index":
                axis = next(d for d in range(full.ndim)
                            if full.shape[d] != one.shape[d])
                full.narrow(axis, row, 1).copy_(one)
    caches["index"] = torch.tensor(lengths, dtype=torch.int32)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (STEPS, B, 1)))
    return jp, params, caches, tokens


def clone(tree):
    return rebuild(tree, iter([x.clone() for _, x in leaves(tree)]))


def write_inputs(seed=11):
    """Caches (B, S, H, D), new k/v for a per-slot and a span write, the
    per-slot indices (the shard boundary at 12 of 24, and a ring of 16 past
    its wrap), and a query for ``decode_attention``."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    for heads in (1, 2):
        for s in (24, 16):
            out[heads, s] = {
                "k": torch.randn(B, s, heads, 8, generator=g),
                "v": torch.randn(B, s, heads, 8, generator=g),
                "k1": torch.randn(B, 1, heads, 8, generator=g),
                "v1": torch.randn(B, 1, heads, 8, generator=g),
                "kt": torch.randn(B, 10, heads, 8, generator=g),
                "vt": torch.randn(B, 10, heads, 8, generator=g),
                "q": torch.randn(B, 1, 4, 8, generator=g),
                "index": (torch.tensor([11, 12, 23, 0, 5, 17]) if s == 24
                          else torch.tensor([15, 16, 17, 31, 7, 8])),
            }
    return out


def plain_writes(w, s):
    """What the plain code makes of ``write_inputs``' entry: (the cache
    after the per-slot write, after a span write at 7, the attention out)."""
    ring = s == 16
    per = attention.KVCache(w["k"].clone(), w["v"].clone())
    idx = w["index"] % s if ring else w["index"]
    attention._write(per, w["k1"], w["v1"], idx, True)
    out = attention.decode_attention(w["q"], per, w["index"] + 1,
                                     window=16 if ring else None, ring=ring)
    span = attention.KVCache(w["k"].clone(), w["v"].clone())
    attention._write(span, w["kt"], w["vt"], 7, False)
    return per, span, out


def split_dims(placements):
    """The tensor dim each mesh dim splits (None where it replicates)."""
    return tuple(p.dim if p.is_shard() else None for p in placements)


def rank_main(rank, init_file, out_dir, inputs_path):
    """One rank: the write units, then every case's decode steps."""
    import torch.distributed as dist
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.dist import sharding as shd
    from repro_torch.launch import specs
    from repro_torch.launch.mesh import make_mesh
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=WORLD, rank=rank,
                            timeout=datetime.timedelta(seconds=JOIN_S))
    try:
        mesh = make_mesh(*MESH, device_type="cpu")
        given = torch.load(inputs_path, weights_only=False)

        def place(tree, shardings):
            return rebuild(tree, iter([
                distribute_tensor(x, sh.mesh, sh.placements,
                                  src_data_rank=None)
                for (_, x), (_, sh) in zip(leaves(tree), leaves(shardings))]))

        def whole(tree):
            return rebuild(tree, iter([x.full_tensor()
                                       for _, x in leaves(tree)]))

        out = {"writes": {}}
        for (heads, s), w in given["writes"].items():
            ring = s == 16
            sh = specs._cache_shardings({"k": w["k"], "v": w["v"]}, None,
                                        mesh, B)
            with shd.use_mesh(mesh), implicit_replication(), torch.no_grad():
                per = attention.KVCache(*place((w["k"].clone(),
                                                w["v"].clone()),
                                               (sh["k"], sh["v"])))
                idx = w["index"] % s if ring else w["index"]
                attention._write(per, w["k1"], w["v1"], idx, True)
                att = attention.decode_attention(
                    w["q"], per, w["index"] + 1, window=16 if ring else None,
                    ring=ring)
                span = attention.KVCache(*place((w["k"].clone(),
                                                 w["v"].clone()),
                                                (sh["k"], sh["v"])))
                attention._write(span, w["kt"], w["vt"], 7, False)
            out["writes"][heads, s] = {
                "per": whole(per), "span": whole(span),
                "out": att.full_tensor(),
                "placements": split_dims(per.k.placements)}

        for case, (params, caches, tokens) in given["cases"].items():
            cfg = cfg_of(case)[1]
            p = place(params, shd.params_shardings(params, cfg, mesh))
            c_sh = specs._cache_shardings(caches, cfg, mesh, B)
            c = place(caches, c_sh)
            ptrs = [x.to_local().data_ptr() for n, x in leaves(c)
                    if n != "index"]
            tok_sh = specs._batch_shardings({"tokens": tokens[0]},
                                            mesh)["tokens"]
            step = specs._serve_fn(
                lambda p, t, c: tt.decode_step(p, cfg, t, c), mesh)
            logits = []
            for i in range(STEPS):
                lg, c, _ = step(p, place(tokens[i], tok_sh), c)
                logits.append(lg.full_tensor())
            out[case] = {
                "logits": torch.stack(logits), "caches": whole(c),
                "in_place": ptrs == [x.to_local().data_ptr()
                                     for n, x in leaves(c) if n != "index"],
                "placements": {n: (split_dims(sh.placements), x.ndim)
                               for (n, sh), (_, x)
                               in zip(leaves(c_sh), leaves(caches))}}
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(every case's inputs, each rank's results) of one 4-rank gloo run."""
    d = tmp_path_factory.mktemp("mesh_decode")
    inputs = {case: inputs_of(case) for case in CASES}
    given = {"writes": write_inputs(),
             "cases": {case: (params, caches, tokens) for case,
                       (_, params, caches, tokens) in inputs.items()}}
    torch.save(given, d / "inputs.pt")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=rank_main,
                         args=(r, str(d / "rendezvous"), str(d),
                               str(d / "inputs.pt")))
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
    return inputs, [torch.load(d / f"rank{r}.pt", weights_only=False)
                    for r in range(WORLD)]


def plain_decode(case, inputs):
    """The plain decode from the same caches: (logits (STEPS, B, 1, V), the
    caches after the last step)."""
    cfg = cfg_of(case)[1]
    _, params, caches, tokens = inputs
    c, logits = clone(caches), []
    with torch.no_grad():
        for i in range(STEPS):
            lg, c, _ = tt.decode_step(params, cfg, tokens[i], c)
            logits.append(lg)
    return torch.stack(logits), c


def within(got, want, what):
    err = float((got - want).abs().max())
    assert err <= RTOL * float(want.abs().max()), (what, err)


@pytest.mark.parametrize("heads", (1, 2))
@pytest.mark.parametrize("s", (24, 16))
def test_writes_land_in_their_shards_byte_for_byte(runs, heads, s):
    """Per slot at the seq shards' boundary (11, 12 of 24) and across a
    ring of 16's wrap, and a span over [7, 17) that straddles the shards,
    into a cache split on seq (1 kv head) or heads (2): each rank writes
    what its shard holds, and the gathered cache is the plain write's. The
    partial-softmax combine over the written cache is the plain softmax."""
    w = write_inputs()[heads, s]
    per, span, out = plain_writes(w, s)
    for rank, got in enumerate(runs[1]):
        r = got["writes"][heads, s]
        assert r["placements"] == (0, 1 if heads == 1 else 2), \
            r["placements"]
        for a, b in zip(r["per"] + r["span"], per + span):
            assert torch.equal(a, b), rank
        within(r["out"], out, (rank, "decode_attention"))


@pytest.mark.parametrize("case", sorted(CASES))
def test_mesh_decode_equals_the_plain_decode(runs, case):
    inputs, ranks = runs
    want_logits, want = plain_decode(case, inputs[case])
    before = inputs[case][2]
    split = CASES[case][4]
    for rank, got in enumerate(ranks):
        r = got[case]
        assert r["in_place"], rank            # every cache shard written in place
        kv = [p for n, p in r["placements"].items()
              if n.endswith(("/k", "/v"))]
        # `model` splits the leaf's heads or seq, past its stacked axes
        assert all(p[1] == nd - 4 + split for p, nd in kv), kv
        assert bool(kv) == (split is not None)
        within(r["logits"], want_logits, (rank, "logits"))
        g, w, b = leaves(r["caches"]), leaves(want), leaves(before)
        assert [n for n, _ in g] == [n for n, _ in w]
        for (n, x), (_, y), (_, x0) in zip(g, w, b):
            if n == "index":
                assert torch.equal(x, y), (rank, n)
                continue
            if n.endswith(("/k", "/v")):
                # untouched entries byte for byte, written ones where the
                # plain decode writes them
                assert torch.equal(x != x0, y != x0), (rank, n)
                assert torch.equal(x[x == x0], y[x == x0]), (rank, n)
            within(x, y, (rank, n))


@pytest.mark.parametrize("case", sorted(CASES))
def test_mesh_decode_matches_the_reference(runs, case):
    inputs, ranks = runs
    jcfg = cfg_of(case)[0]
    jp, _, caches, tokens = inputs[case]
    _, _, max_len, _, _ = CASES[case]
    treedef = jax.tree.structure(jt.init_caches(jcfg, B, max_len))
    jc = jax.tree.unflatten(treedef, [jnp.asarray(to_numpy(x))
                                      for _, x in leaves(caches)])
    step = jax.jit(lambda p, t, c: jt.decode_step(p, jcfg, t, c))
    for i in range(STEPS):
        lg, jc, _ = step(jp, jnp.asarray(tokens[i].numpy().astype(np.int32)),
                         jc)
        np.testing.assert_allclose(ranks[0][case]["logits"][i].numpy(),
                                   np.asarray(lg), rtol=REF_RTOL,
                                   atol=REF_ATOL)
