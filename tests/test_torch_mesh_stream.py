"""The residual stream laid out once on a mesh: the mesh train step on 4
gloo ranks against the plain single-process step.

Four processes (``torch.multiprocessing`` spawn, a file rendezvous under
``tmp_path``) form a (2, 2) ``("data", "model")`` mesh. Each places one
seeded f32 state with ``jit_train_step`` (profiles ``tp`` and ``fsdp_tp``)
and runs one step on a batch of 4 x 32 tokens. A step that writes no
cache lays its stream out once (``sharding.stream``), so the attention
and MLP sub-layers run on local shards (``sharding.shard_call``):
column-parallel in, row-parallel out, each weight moved to where its
layer uses it, the CE's positions split over ``model``. Held to the plain
single-process code in this process, each within 1e-5 (relative for a
scalar, of the leaf's max |x| for a tensor; the mesh sums its
projections over shards in another order):

* the gradients ``opt.update`` receives, gathered, and the loss: to one
  plain ``loss_fn`` gradient;
* grad norm, lr and the first moments: to one plain ``make_train_step``;
* the params: to the plain update of the mesh's own gradients (AdamW's
  first step moves a param by lr g / (|g| + eps), so a gradient within
  eps of zero turns its rounding into a tenth of lr);
* and each gradient reaches ``opt.update`` in its ZeRO-1 moments'
  placements.

Cases, reduced configs: a dense arch whose kv heads divide ``model``; the
same with one kv head (each rank projects the kv head its query heads
read); the same with 3 query heads on 2 ranks (the query rows split
instead); whisper-tiny with 3 heads (the encoder and the decoder's
cross-attention over row-split queries); the vlm's cross blocks; zamba2's
shared attention beside its Mamba2 layers; a MoE arch (its own layout,
over the stream) and xlstm. Each rank also checks that its sub-layers ran
on local shards: zamba2's Mamba2 and xlstm's mLSTM and sLSTM layers each
on plain tensors of its one row (4 rows over the data axes and ``model``
together), weights whole.

On a (1, 1) mesh (one gloo rank in this process), where the stream's
layout costs nothing, a bf16 mesh step of each family equals the plain
step byte for byte: the sub-layers' local code is the plain code.
"""

import dataclasses
import datetime
import functools
import os

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro_torch.models import get_arch
from repro_torch.models import transformer as tt
from repro_torch.train import optimizer as opt
from repro_torch.train import trainer
from repro_torch.tree import leaves, tree_map

WORLD = 4
MESH = ((2, 2), ("data", "model"))
CASES = {"dense": ("granite-3-8b", {}),
         "one_kv_head": ("granite-3-8b", {"n_kv_heads": 1}),
         "row_split": ("granite-3-8b", {"n_heads": 3, "n_kv_heads": 3}),
         "audio": ("whisper-tiny", {"n_heads": 3, "n_kv_heads": 3}),
         "vlm": ("llama-3.2-vision-11b", {}),
         "hybrid": ("zamba2-2.7b", {}),
         "moe": ("granite-moe-1b-a400m", {}),
         "ssm": ("xlstm-1.3b", {})}
PROFILES = ("tp", "fsdp_tp")
# the mesh train test's: at lr 1e-4 an update wrong by 5 % of lr shows
OCFG = dict(lr=1e-4, warmup_steps=1, total_steps=50, grad_clip=1.0)
B, T = 4, 32
RTOL = 1e-5
JOIN_S = 300
RECURRENT = ("mamba2_apply", "mlstm_apply", "slstm_apply")
# the recurrent kinds each case's stack runs
KINDS = {"hybrid": {"mamba2_apply"}, "ssm": {"mlstm_apply", "slstm_apply"}}


def cfg_of(case):
    arch, kw = CASES[case]
    return dataclasses.replace(get_arch(arch).reduced(), dtype="float32", **kw)


def batch_of(case):
    cfg = cfg_of(case)
    rng = np.random.default_rng(4)
    tok = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
    lab = np.concatenate([tok[:, 1:], np.full((B, 1), -1, np.int32)], 1)
    b = {"tokens": torch.as_tensor(tok), "labels": torch.as_tensor(lab)}
    if cfg.family == "vlm":
        b["image_embeds"] = torch.as_tensor(rng.standard_normal(
            (B, cfg.n_image_tokens, cfg.d_model)).astype(np.float32))
    if cfg.family == "audio":
        b["encoder_frames"] = torch.as_tensor(rng.standard_normal(
            (B, T // cfg.encoder_seq_divisor, cfg.d_model)).astype(np.float32))
    return b


def init(case):
    return trainer.init_state(cfg_of(case), torch.Generator().manual_seed(6),
                              device="cpu")


def rank_main(rank, init_file, out_dir):
    """One rank: every case under both profiles, one mesh step each."""
    import torch.distributed as dist
    from repro_torch.dist import sharding as shd
    from repro_torch.launch.mesh import make_mesh
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=WORLD, rank=rank,
                            timeout=datetime.timedelta(seconds=JOIN_S))
    from repro_torch.models import layers, ssm
    calls, given, recurrent = [], [], []
    use_weight, update = shd.use_weight, opt.update
    applies = {k: getattr(ssm, k) for k in RECURRENT}

    def spy_weight(w, dim):
        # a weight moved to where a layer over the stream uses it
        calls.append(1)
        return use_weight(w, dim)

    def spy_apply(kind):
        # a recurrent sub-layer: the types and shapes it was given
        def apply(p, x, cfg, **kw):
            recurrent.append((kind, type(x).__name__, tuple(x.shape),
                              tuple(sorted({type(w).__name__
                                            for _, w in leaves(p)}))))
            return applies[kind](p, x, cfg, **kw)
        return apply

    def spy_update(ocfg, grads, state, params, **kw):
        given.append({
            "grads": tree_map(lambda t: t.full_tensor(), grads),
            "placed": [(tuple(g.placements), tuple(m.placements))
                       for (_, g), (_, m) in zip(leaves(grads),
                                                 leaves(state.m))]})
        return update(ocfg, grads, state, params, **kw)

    holders = (shd, layers, tt)
    for m in holders:
        m.use_weight = spy_weight
    opt.update = spy_update
    for k in RECURRENT:
        setattr(ssm, k, spy_apply(k))
    try:
        mesh = make_mesh(*MESH, device_type="cpu")
        out = {}
        for case in CASES:
            for profile in PROFILES:
                step, state = trainer.jit_train_step(
                    cfg_of(case), opt.OptConfig(**OCFG), mesh, init(case),
                    profile)
                del calls[:], recurrent[:]
                state, metrics = step(state, batch_of(case))
                out[case, profile] = dict(
                    given[-1], metrics=metrics, local_calls=len(calls),
                    recurrent=list(recurrent),
                    params=tree_map(lambda t: t.full_tensor(), state.params),
                    m=tree_map(lambda t: t.full_tensor(), state.opt.m))
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        for m in holders:
            m.use_weight = use_weight
        opt.update = update
        for k, fn in applies.items():
            setattr(ssm, k, fn)
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Each rank's results of one 4-rank gloo run."""
    d = tmp_path_factory.mktemp("mesh_stream")
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


def _bad(got: dict, want: dict) -> list:
    """The leaves of ``got`` off ``want`` by more than RTOL of the leaf's
    max |x|: (name, max |got - want|, max |want|)."""
    assert sorted(got) == sorted(want)
    return [(n, float((g - want[n]).abs().max()), float(want[n].abs().max()))
            for n, g in got.items()
            if float((g - want[n]).abs().max())
            > RTOL * float(want[n].abs().max())]


@functools.lru_cache(maxsize=None)
def plain_grads(case):
    """(total loss, gradients) of one plain ``loss_fn`` on the case's
    state and batch (both profiles share them)."""
    cfg = cfg_of(case)
    total, _, grads = trainer._grads(
        lambda p: tt.loss_fn(p, cfg, batch_of(case)), init(case).params)
    return total, grads


@functools.lru_cache(maxsize=None)
def plain_step(case):
    """(state', metrics) of one plain ``make_train_step`` call."""
    return trainer.make_train_step(cfg_of(case), opt.OptConfig(**OCFG))(
        init(case), batch_of(case))


@pytest.mark.parametrize("profile", PROFILES)
@pytest.mark.parametrize("case", sorted(CASES))
def test_stream_gradients_equal_the_plain_ones(ranks, case, profile):
    want_total, want = plain_grads(case)
    for rank, got in enumerate(ranks):
        r = got[case, profile]
        assert r["local_calls"] > 0, rank
        if case in KINDS:
            # forward and recompute: each on plain tensors of its one row
            assert {k for k, *_ in r["recurrent"]} == KINDS[case], rank
            assert {tuple(c[1:]) for c in r["recurrent"]} == {
                ("Tensor", (B // WORLD, T, cfg_of(case).d_model),
                 ("Tensor",))}, (rank, r["recurrent"])
        total = float(r["metrics"]["total"])
        assert abs(total - float(want_total)) <= RTOL * abs(float(want_total))
        assert not _bad(dict(leaves(r["grads"])), dict(leaves(want))), rank


@pytest.mark.parametrize("profile", PROFILES)
@pytest.mark.parametrize("case", sorted(CASES))
def test_stream_step_equals_the_plain_step(ranks, case, profile):
    ocfg = opt.OptConfig(**OCFG)
    want, wm = plain_step(case)
    for rank, got in enumerate(ranks):
        r = got[case, profile]
        for k in ("grad_norm", "lr", "loss"):
            assert abs(float(r["metrics"][k]) - float(wm[k])) <= \
                RTOL * abs(float(wm[k])), (rank, k)
        assert r["placed"] and all(g == m for g, m in r["placed"]), rank
        assert not _bad(dict(leaves(r["m"])), dict(leaves(want.opt.m))), rank
        fresh = init(case)
        moved, _, _ = opt.update(ocfg, r["grads"], fresh.opt, fresh.params)
        assert not _bad(dict(leaves(r["params"])), dict(leaves(moved))), rank


@pytest.mark.parametrize("case", ["dense", "audio", "vlm", "hybrid", "moe",
                                  "ssm"])
def test_a_one_rank_mesh_step_is_the_plain_step(case, tmp_path):
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    cfg = dataclasses.replace(cfg_of(case), dtype="bfloat16")
    batch = {k: v.to(torch.bfloat16) if v.is_floating_point() else v
             for k, v in batch_of(case).items()}
    state = trainer.init_state(cfg, torch.Generator().manual_seed(6),
                               device="cpu")
    plain, want = trainer.make_train_step(cfg, opt.OptConfig())(
        tree_map(torch.clone, state), batch)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rdv'}",
                            rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), device_type="cpu")
        step, placed = trainer.jit_train_step(cfg, opt.OptConfig(), mesh,
                                              state)
        placed, got = step(placed, batch)
    finally:
        dist.destroy_process_group()
    assert float(got["loss"]) == float(want["loss"])
    for (n, a), (_, b) in zip(leaves(placed.params), leaves(plain.params)):
        assert torch.equal(a.to_local(), b), n
