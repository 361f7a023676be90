"""What ``repro_torch.analysis.op_cost`` counts, and the analytic FLOPs of
``repro_torch.analysis.accounting`` against the reference's.

* the reference's three ground truths of ``tests/test_hlo_cost.py``,
  within its bounds: a loop of 10 (16x32)@(32x32) matmuls, a plain
  (64x128)@(128x256) with bytes >= operands plus result, and nested 5x3
  loops (each Python iteration counts as it runs: no trip-count
  correction);
* one rank of a (4, 4) mesh (a fake process group, meta tensors) counts
  fewer FLOPs than the same train step on a (1, 1) mesh, and at least 1/16
  of them, and counts the collectives its shards need; DTensor's own
  all-to-all counts as one;
* ``accounting.param_counts`` and ``model_flops`` equal the reference's for
  every arch x {train, prefill, decode} at the cells' shapes.
"""

import dataclasses

import pytest
import torch

from repro.analysis import accounting as jaccounting
from repro.models import config as jconfig
from repro_torch.analysis import accounting, op_cost
from repro_torch.launch import dryrun, specs
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import get_arch, list_archs
from repro_torch.train import optimizer as opt
from repro_torch.train import trainer


def test_loop_of_matmuls_counts_every_iteration():
    x, w = torch.randn(16, 32), torch.randn(10, 32, 32)

    def f(x, w):
        for i in range(10):
            x = x @ w[i]
        return x

    c = op_cost.analyze(f, x, w)
    expected = 10 * 2 * 16 * 32 * 32
    assert abs(c.flops - expected) / expected < 0.01
    assert c.total_coll_bytes == 0 and c.coll_count == {}


def test_plain_matmul_flops_and_bytes():
    c = op_cost.analyze(lambda a, b: a @ b, torch.randn(64, 128),
                        torch.randn(128, 256))
    expected = 2 * 64 * 128 * 256
    assert abs(c.flops - expected) / expected < 0.01
    assert c.bytes >= (64 * 128 + 128 * 256 + 64 * 256) * 4


def test_nested_loops():
    x, w = torch.randn(8, 16), torch.randn(5, 16, 16)

    def f(x, w):
        for i in range(5):
            for _ in range(3):
                x = torch.tanh(x @ w[i])
        return x

    c = op_cost.analyze(f, x, w)
    expected = 5 * 3 * 2 * 8 * 16 * 16
    assert abs(c.flops - expected) / expected < 0.05


def _mesh_step_cost(shape):
    cfg = dataclasses.replace(get_arch("granite-3-8b").reduced(),
                              dtype="float32")
    batch = specs.batch_specs(cfg, 8, 32)
    with dryrun.fake_group(shape[0] * shape[1]):
        mesh = make_mesh(shape, ("data", "model"), device_type="cpu")
        step, state = trainer.jit_train_step(
            cfg, opt.OptConfig(), mesh, trainer.init_state(cfg, device="meta"))
        return op_cost.analyze(step, state, batch)


def test_one_rank_of_a_mesh_counts_its_share():
    whole = _mesh_step_cost((1, 1))
    rank = _mesh_step_cost((4, 4))
    assert whole.flops > 0
    assert whole.flops / 16 <= rank.flops < whole.flops
    assert rank.total_coll_bytes > 0
    assert set(rank.coll_count) <= set(op_cost.KINDS)


def test_dtensor_all_to_all_counts_as_one():
    """DTensor's own all-to-all (a shard moved between dims over a mesh
    dim, as the stream moves from its sequence to its rows on the card)
    counts as an ``all_to_all`` of its output's bytes."""
    import torch.distributed._functional_collectives as funcol
    import torch.distributed.tensor._collective_utils  # noqa: F401 (the op)
    with dryrun.fake_group(4):
        mesh = make_mesh((1, 4), ("data", "model"), device_type="cpu")
        group = funcol._group_or_group_name(funcol._resolve_group((mesh, 1)))
        c = op_cost.analyze(
            lambda x: torch.ops._dtensor.shard_dim_alltoall(x, 1, 0, group),
            torch.empty(4, 8, 16, device="meta"))
    assert c.coll_count == {"all_to_all": 1}
    assert c.coll_bytes == {"all_to_all": 1 * 32 * 16 * 4}


@pytest.mark.parametrize("arch", list_archs())
def test_accounting_matches_the_reference(arch):
    cfg, jcfg = get_arch(arch), jconfig.get_arch(arch)
    assert accounting.param_counts(cfg) == jaccounting.param_counts(jcfg)
    for info in specs.SHAPES.values():
        kind, b, t = info["kind"], info["global_batch"], info["seq_len"]
        t_in = 1 if kind == "decode" else t
        got = accounting.model_flops(cfg, kind, b, t_in, cache_len=t)
        want = jaccounting.model_flops(jcfg, kind, b, t_in, cache_len=t)
        assert got.keys() == want.keys()
        for k in want:
            assert abs(got[k] - want[k]) <= 1e-12 * abs(want[k]), (kind, k)


def test_flops_are_counted_by_op_and_site():
    """Two matmuls in a function of known site, then their gradients: the
    forward pair under the function's name, the backward pair under the
    autograd node that runs them."""
    a = torch.randn(8, 16, requires_grad=True)
    b, c = torch.randn(16, 32), torch.randn(32, 4)

    def two_matmuls(a, b, c):
        return (a @ b) @ c

    def step():
        two_matmuls(a, b, c).sum().backward()

    cost = op_cost.analyze(step)
    forward = 2 * 8 * 16 * 32 + 2 * 8 * 32 * 4
    # d(a @ b) = g @ c.T, then d(a) = d(a @ b) @ b.T: b and c need no grad
    backward = 2 * 8 * 4 * 32 + 2 * 8 * 32 * 16
    sites = op_cost.flop_sites(cost)
    assert sites == {
        "mm @ test_torch_op_cost.py:two_matmuls": {"flops": forward,
                                                   "count": 2},
        "mm @ backward MmBackward0": {"flops": backward, "count": 2}}
    assert cost.flops == forward + backward
