"""A rank of the multi-pod mesh does the reference's share of a train step.

On the production (2, 16, 16) ``("pod", "data", "model")`` mesh a train_4k
batch of 256 rows leaves 8 rows to each of the 32 data ranks, which
``model``'s 16 ranks hold whole: the rows cut into 8 parts of one row and
each part's 2 ``model`` ranks split its recurrent layers' heads
(``repro_torch.dist.sharding.row_share``). zamba2-2.7b cut to 6 layers (the
shared attention and 6 Mamba2 layers, 80 heads each): the port's rank 0
on ``meta`` under a fake group (``op_cost`` of ``specs.make_cell``) counts
at most 1.05 times one device of the reference's step on the same mesh
(``tools/reference_rank_flops.py --mesh 2x16x16``, Auto axes on 512 host
devices), and no less than 0.9 times it. Each count in a subprocess of its
own, side by side. A file apart from ``test_torch_mesh_share.py`` so that
the two run on different workers. The rules behind the split, on abstract
meshes: the parts and share of a batch's rows, the ways a layer's heads
split over the share, and each recurrent arch's heads.
"""

import sys

import pytest

from repro_torch.dist import sharding as shd
from repro_torch.models import get_arch, ssm
from tests.test_torch_mesh_share import counts

ARCH, LAYERS = "zamba2-2.7b", 6
SHARE = 1.05            # the port's rank against the reference's
FLOOR = 0.90            # and the work it may not skip

PORT = r"""
import json, math, sys
from repro_torch.analysis import op_cost
from repro_torch.launch import dryrun, specs
from repro_torch.launch.mesh import make_mesh
shape, axes = dryrun.mesh_of("multi")
name = dryrun.at_depth(sys.argv[1], int(sys.argv[2]))
with dryrun.fake_group(math.prod(shape)):
    mesh = make_mesh(shape, axes, device_type="cpu")
    cell = specs.make_cell(name, "train_4k", mesh, device="meta")
    flops = op_cost.analyze(cell.fn, *cell.args).flops
print(json.dumps({"mesh": list(shape), "flops": flops}))
"""


def test_a_multi_pod_rank_counts_the_reference_share():
    ref, port = counts(
        [sys.executable, "tools/reference_rank_flops.py", "--arch", ARCH,
         "--layers", str(LAYERS), "--mesh", "2x16x16"],
        [sys.executable, "-c", PORT, ARCH, str(LAYERS)])
    share = port["2x16x16"] / ref["2x16x16"]
    assert FLOOR <= share <= SHARE, (port, ref, share)


# (mesh, rows) -> (parts, share)
ROW_SHARES = [(((2, 16, 16), ("pod", "data", "model")), 256, (8, 2)),
              (((16, 16), ("data", "model")), 256, (1, 1)),
              (((2, 2), ("data", "model")), 4, (1, 1)),
              (((2, 2), ("data", "model")), 2, (1, 2)),
              (((1, 4), ("data", "model")), 2, (2, 2)),
              (((1, 4), ("data", "model")), 1, (1, 4)),
              (((2, 2), ("data", "model")), 1, (1, 1)),
              (((4,), ("data",)), 2, (1, 1))]


@pytest.mark.parametrize("mesh,rows,want", ROW_SHARES)
def test_row_share(mesh, rows, want):
    """Where ``model`` holds a data rank's rows whole they cut into the
    most parts that both divide, each shared by the rest of ``model``;
    rows that split over ``model``, or do not split over the data axes,
    are nobody's to share."""
    assert shd.row_share(shd.AbstractMesh(*mesh), rows) == want


@pytest.mark.parametrize("heads,share,ways", [(80, 2, 2), (4, 2, 2),
                                              (4, 16, 4), (8, 4, 4),
                                              (2, 4, 2), (3, 4, 1),
                                              (6, 4, 2), (4, 1, 1)])
def test_head_ways(heads, share, ways):
    assert shd.head_ways(heads, share) == ways


@pytest.mark.parametrize("arch,want", [
    ("zamba2-2.7b", {"mamba2": 80}), ("xlstm-1.3b", {"mlstm": 4, "slstm": 4}),
    ("granite-3-8b", {})])
def test_recurrent_heads(arch, want):
    """What a share group splits: zamba2's 5,120 / 64 Mamba2 heads, and
    xlstm's 4 mLSTM and sLSTM heads, so every recurrent layer splits
    2 ways on the multi-pod mesh."""
    assert ssm.recurrent_heads(get_arch(arch)) == want
