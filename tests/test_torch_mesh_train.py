"""The mesh train step on 4 gloo ranks against the plain single-process step.

Four processes (``torch.multiprocessing`` spawn, a file rendezvous under
``tmp_path``) form a (2, 2) ``("data", "model")`` mesh. Each places one
seeded state with ``jit_train_step`` (profiles ``tp`` and ``fsdp_tp``, so
params, ZeRO-1 moments and the batch are sharded over both axes) and runs
one step; the metrics and the first moments, gathered, are held to one
plain ``make_train_step`` call on the same state and batch in this
process, in f32: the loss, grad norm and lr within 1e-5 relative, every
first-moment leaf (0.1 of the gradient) within 1e-5 of its max |x| (the
sums run in another order across ranks). The whole params are held, at
the same bound, to the plain update of the gradients the mesh step gave
``opt.update``, gathered: AdamW's first step moves a param by lr g / (|g|
+ eps), so a gradient within eps of zero (the dense case's ``wq`` holds
one of -3.7e-8) turns its rounding into a tenth of lr. Four
reduced configs: a dense arch, a MoE arch (tables and gathers batch-local
through ``shard_map_batch``, experts over ``model``), the dense arch
with one kv head, which takes the full-head form (k and v broadcast to
the query heads before the heads split), and an ssm arch (xlstm: its
mLSTM and sLSTM layers run on each rank's one row, the batch split over
both axes, as plain tensors, their weights whole, with their gradients
summed over the ranks' rows). Four more hold a batch of 2 rows, which do
not divide over both axes, for xlstm and for zamba2 (the shared attention
beside Mamba2 layers): on (2, 2) the 2 ``model`` ranks of each data rank
share its one row, each taking half of every recurrent layer's heads; on a
(1, 4) mesh the 2 rows are cut into 2 parts of one row, each shared so by 2
``model`` ranks, the parts' outputs summed and gathered. Three hold one
row on (1, 4), shared by all 4 ranks: xlstm's 4 heads and zamba2's 8
split 4 ways, and xlstm with 2 heads splits them 2 ways, each pair of
ranks computing the same heads. Each rank records the share and the ways
of every recurrent layer it ran. The
gradients ``opt.update``
receives already hold their moments' placements: the mesh step
reduce-scatters them there before the clip.
"""

import dataclasses
import datetime
import os

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro_torch.models import get_arch
from repro_torch.train import optimizer as opt
from repro_torch.train import trainer
from repro_torch.tree import leaves, tree_map

WORLD = 4
MESH = ((2, 2), ("data", "model"))
CASES = {"dense": ("granite-3-8b", {}),
         "moe": ("granite-moe-1b-a400m", {}),
         "one_kv_head": ("granite-3-8b", {"n_kv_heads": 1}),
         "ssm": ("xlstm-1.3b", {}),
         "ssm_two_rows": ("xlstm-1.3b", {}),
         "hybrid_two_rows": ("zamba2-2.7b", {}),
         "ssm_rows_in_parts": ("xlstm-1.3b", {}),
         "hybrid_rows_in_parts": ("zamba2-2.7b", {}),
         "ssm_one_row": ("xlstm-1.3b", {}),
         "hybrid_one_row": ("zamba2-2.7b", {}),
         "ssm_one_row_two_heads": ("xlstm-1.3b", {"n_heads": 2})}
# the batch's rows (4 split over data and model together) and the mesh
ROWS = {"ssm_two_rows": 2, "hybrid_two_rows": 2, "ssm_rows_in_parts": 2,
        "hybrid_rows_in_parts": 2, "ssm_one_row": 1, "hybrid_one_row": 1,
        "ssm_one_row_two_heads": 1}
SHAPE = {"ssm_rows_in_parts": (1, 4), "hybrid_rows_in_parts": (1, 4),
         "ssm_one_row": (1, 4), "hybrid_one_row": (1, 4),
         "ssm_one_row_two_heads": (1, 4)}
# (share, ways) of each recurrent layer: the model ranks that share a row,
# and over how many of them its heads split (the rest duplicate)
SHARE = {"ssm_two_rows": (2, 2), "hybrid_two_rows": (2, 2),
         "ssm_rows_in_parts": (2, 2), "hybrid_rows_in_parts": (2, 2),
         "ssm_one_row": (4, 4), "hybrid_one_row": (4, 4),
         "ssm_one_row_two_heads": (4, 2)}
RECURRENT = ("mamba2_apply", "mlstm_apply", "slstm_apply")
KINDS = ("ssm",)       # the other cases with recurrent layers
PROFILES = ("tp", "fsdp_tp")
# AdamW's first step moves a param by ~lr wherever |g| >> eps, whatever |g|:
# at lr 1e-4 the rounding of near-zero gradients stays inside the bound,
# while an update wrong by more than 5 % of lr would not
OCFG = dict(lr=1e-4, warmup_steps=1, total_steps=50, grad_clip=1.0)
RTOL = 1e-5
JOIN_S = 300


def cfg_of(case):
    arch, kw = CASES[case]
    return dataclasses.replace(get_arch(arch).reduced(), dtype="float32", **kw)


def init(case):
    return trainer.init_state(cfg_of(case), torch.Generator().manual_seed(5),
                              device="cpu")


def batch_of(case):
    rng = np.random.default_rng(3)
    rows = ROWS.get(case, 4)
    tok = rng.integers(0, cfg_of(case).vocab_size, (rows, 24)).astype(np.int32)
    lab = np.concatenate([tok[:, 1:], np.full((rows, 1), -1, np.int32)], 1)
    return {"tokens": torch.as_tensor(tok), "labels": torch.as_tensor(lab)}


def rank_main(rank, init_file, out_dir):
    """One rank: every case under both profiles, one mesh step each."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import ssm
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=WORLD, rank=rank,
                            timeout=datetime.timedelta(seconds=JOIN_S))
    placed, given, recurrent = [], [], []
    update = opt.update
    applies = {k: getattr(ssm, k) for k in RECURRENT}

    def spy_apply(kind):
        # a recurrent sub-layer: the type and shape of the x it was given,
        # the ranks that shared it and the ways its heads split
        def apply(p, x, cfg, **kw):
            out = applies[kind](p, x, cfg, **kw)
            group = kw.get("group")
            recurrent.append((type(x).__name__, tuple(x.shape)) + (
                (group.share, group.ways) if group else (1, 1)))
            return out
        return apply

    def spy(ocfg, grads, state, params, **kw):
        # each gradient's placements beside its moments', and the gradients
        placed.append([(tuple(g.placements), tuple(m.placements))
                       for (_, g), (_, m) in zip(leaves(grads),
                                                 leaves(state.m))])
        given.append(tree_map(lambda t: t.full_tensor(), grads))
        return update(ocfg, grads, state, params, **kw)

    opt.update = spy
    for k in RECURRENT:
        setattr(ssm, k, spy_apply(k))
    try:
        meshes = {shape: make_mesh(shape, MESH[1], device_type="cpu")
                  for shape in {MESH[0], *SHAPE.values()}}
        out = {}
        for case in CASES:
            for profile in PROFILES:
                cfg = cfg_of(case)
                step, state = trainer.jit_train_step(
                    cfg, opt.OptConfig(**OCFG),
                    meshes[SHAPE.get(case, MESH[0])], init(case), profile)
                held = {k: sum(x.to_local().numel() for _, x in leaves(t))
                        for k, t in (("params", state.params),
                                     ("m", state.opt.m))}
                del recurrent[:]
                state, m = step(state, batch_of(case))
                out[case, profile] = {
                    "params": tree_map(lambda t: t.full_tensor(), state.params),
                    "m": tree_map(lambda t: t.full_tensor(), state.opt.m),
                    "metrics": m, "held": held,
                    "grad_placements": placed[-1], "grads": given[-1],
                    "recurrent": set(recurrent)}
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        opt.update = update
        for k, fn in applies.items():
            setattr(ssm, k, fn)
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Each rank's results of one 4-rank gloo run."""
    d = tmp_path_factory.mktemp("mesh_train")
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


@pytest.mark.parametrize("profile", PROFILES)
@pytest.mark.parametrize("case", sorted(CASES))
def test_mesh_step_equals_the_plain_step(ranks, case, profile):
    cfg = cfg_of(case)
    state = init(case)
    whole = sum(x.numel() for _, x in leaves(state.params))
    want, wm = trainer.make_train_step(cfg, opt.OptConfig(**OCFG))(
        state, batch_of(case))
    for rank, got in enumerate(ranks):
        r = got[case, profile]
        # a rank holds part of the params (over `model`; fsdp_tp also over
        # `data`) and a quarter or so of the ZeRO-1 moments
        assert r["held"]["params"] < whole, (rank, r["held"])
        assert r["held"]["m"] < whole / 2, (rank, r["held"])
        if case in ROWS:
            # each data rank's one row, or each rank's part of its two, as
            # a plain tensor, its heads split over the ranks that share it
            assert r["recurrent"] == {("Tensor", (1, 24, cfg.d_model))
                                      + SHARE[case]}, (rank, r["recurrent"])
        elif case in KINDS:
            # a rank's own row: no ranks share it
            assert r["recurrent"] == {("Tensor", (1, 24, cfg.d_model), 1,
                                       1)}, (rank, r["recurrent"])
        loss, want_loss = float(r["metrics"]["loss"]), float(wm["loss"])
        assert abs(loss - want_loss) <= RTOL * abs(want_loss), (rank, loss,
                                                                 want_loss)
        for k in ("grad_norm", "lr", "total"):
            assert abs(float(r["metrics"][k]) - float(wm[k])) <= \
                RTOL * abs(float(wm[k])), (rank, k)
        # the first moments are 0.1 g: the gradients leaf by leaf; the
        # params, the plain update of the mesh's own gradients
        fresh = init(case)
        moved, _, _ = opt.update(opt.OptConfig(**OCFG), r["grads"],
                                 fresh.opt, fresh.params)
        for got_tree, want_tree in ((r["params"], moved),
                                    (r["m"], want.opt.m)):
            g, w = leaves(got_tree), leaves(want_tree)
            assert [n for n, _ in g] == [n for n, _ in w]
            bad = [(n, float((a - b).abs().max()), float(b.abs().max()))
                   for (n, a), (_, b) in zip(g, w)
                   if float((a - b).abs().max()) > RTOL * float(b.abs().max())]
            assert not bad, (rank, bad)


@pytest.mark.parametrize("profile", PROFILES)
@pytest.mark.parametrize("case", sorted(CASES))
def test_update_gets_gradients_in_their_moments_placements(ranks, case,
                                                          profile):
    """The mesh step reduces each gradient onto its ZeRO-1 moments'
    placements before the clip, so ``opt.update`` moves no gradient and
    its global norm all-reduces a scalar; the moments are split over
    ``data`` (and the gradients with them) for most leaves, where ``data``
    has more than one rank."""
    for rank, got in enumerate(ranks):
        pairs = got[case, profile]["grad_placements"]
        assert pairs and all(g == m for g, m in pairs), (rank, pairs)
        if SHAPE.get(case, MESH[0])[0] == 1:
            continue
        on_data = sum(getattr(m[0], "dim", None) is not None for _, m in pairs)
        assert on_data > len(pairs) // 2, (rank, on_data, len(pairs))
