"""The port's sharding rules against the reference's, leaf for leaf.

``repro_torch.dist.sharding`` must lay every tensor out as
``repro.dist.sharding`` does. Both rule engines run in this process on
abstract meshes (``jax.sharding.AbstractMesh`` and the port's
``AbstractMesh``) of the sizes the production cells use, so no 256 devices
are needed:

* ``params_shardings`` (profiles ``tp`` and ``fsdp_tp``) and
  ``opt_state_shardings`` give the same spec for every leaf of every arch,
  on (1, 1), (4, 4), (16, 16) and (2, 16, 16);
* ``_resolve_spec`` gives the same spec on seeded random shapes and axes;
* a spec's DTensor placements put on each rank the rows JAX's
  ``NamedSharding`` puts on that device (``devices_indices_map``), tuple
  entries (pod-major) included: in a subprocess with 16 host devices and
  16 fake-process-group ranks, one after another;
* ``constrain`` and ``shard_map_batch`` are the identity outside a mesh.
"""

import functools
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh as JaxAbstractMesh

from repro.dist import sharding as jsh
from repro.models import config as jconfig
from repro.models import transformer as jtransformer
from repro_torch.dist import sharding as shd
from repro_torch.models import get_arch, list_archs, transformer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {"1x1": ((1, 1), ("data", "model")),
          "4x4": ((4, 4), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def meshes(name):
    shape, axes = MESHES[name]
    return JaxAbstractMesh(shape, axes), shd.AbstractMesh(shape, axes)


@functools.lru_cache(maxsize=None)
def jax_params(arch):
    cfg = jconfig.get_arch(arch)
    return jax.eval_shape(
        lambda: jtransformer.init_params(cfg, jax.random.key(0)))


def jax_specs(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jsh._path_str(p): tuple(s.spec) for p, s in flat}


def port_specs(tree):
    from repro_torch.tree import leaves
    return {name: s.spec for name, s in leaves(tree)}


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", list_archs())
def test_state_shardings_match_the_reference(arch, mesh):
    jmesh, pmesh = meshes(mesh)
    jparams = jax_params(arch)
    params = transformer.init_params(get_arch(arch), device="meta")
    jcfg, cfg = jconfig.get_arch(arch), get_arch(arch)
    for profile in ("tp", "fsdp_tp"):
        want = jax_specs(jsh.params_shardings(jparams, jcfg, jmesh, profile))
        got = port_specs(shd.params_shardings(params, cfg, pmesh, profile))
        assert got.keys() == want.keys()
        bad = {n: (got[n], want[n]) for n in want if got[n] != want[n]}
        assert not bad, (profile, bad)
    want = jax_specs(jsh.opt_state_shardings(jparams, jcfg, jmesh))
    got = port_specs(shd.opt_state_shardings(params, cfg, pmesh))
    assert got == want
    if mesh != "1x1":   # the rules shard something on every real mesh
        assert any(s != (None,) * len(s) for s in got.values())


AXES_CHOICES = [None, "batch", "model", "data", "pod", ("pod", "data"),
                ("data", "model"), "missing"]
EXTENTS = [1, 2, 3, 4, 6, 8, 16, 32, 48, 64, 256, 512]


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_resolve_spec_matches_the_reference(mesh):
    jmesh, pmesh = meshes(mesh)
    rng = np.random.default_rng(sorted(MESHES).index(mesh))
    for _ in range(400):
        nd = int(rng.integers(1, 5))
        shape = tuple(int(rng.choice(EXTENTS)) for _ in range(nd))
        axes = [AXES_CHOICES[int(i)]
                for i in rng.integers(0, len(AXES_CHOICES),
                                      int(rng.integers(0, nd + 2)))]
        want = tuple(jsh._resolve_spec(shape, axes, jmesh))
        got = shd.NamedSharding(pmesh, shd._resolve_spec(shape, axes, pmesh))
        assert got.spec == want, (shape, axes)


OFFSETS = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=16"
import jax, numpy as np, torch
import torch.distributed as dist
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import distribute_tensor
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.dist import sharding as shd

shape, axes = (2, 2, 4), ("pod", "data", "model")
jmesh = Mesh(np.array(jax.devices()[:16]).reshape(shape), axes)
cases = [((16, 12), (("pod", "data"), "model")),
         ((8, 4, 16), (None, ("pod", "data"), "model")),
         ((16, 8), ("model", ("pod", "data"))),
         ((4, 8, 12), ("pod", None, "model")),
         ((8, 8), ("data", None)),
         ((4, 4), (None, None))]
checked = 0
for r in range(16):
    dist.init_process_group("fake", store=FakeStore(), rank=r, world_size=16)
    mesh = init_device_mesh("cpu", shape, mesh_dim_names=axes)
    for gshape, spec in cases:
        full = torch.arange(int(np.prod(gshape))).reshape(gshape)
        pl = shd.NamedSharding(mesh, spec).placements
        local = distribute_tensor(full, mesh, pl, src_data_rank=None).to_local()
        idx = NamedSharding(jmesh, P(*spec)).devices_indices_map(gshape)
        dev = next(d for d in idx if d.id == r)
        want = full[tuple(idx[dev])]
        assert torch.equal(local, want), (r, gshape, spec, pl)
        checked += 1
    dist.destroy_process_group()
print("CHECKED", checked)
"""


def test_placements_hold_the_rows_jax_gives_each_device():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, "-c", OFFSETS], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "CHECKED 96" in out.stdout


def test_constrain_and_shard_map_batch_are_the_identity_outside_a_mesh():
    assert shd.current_mesh() is None
    x = torch.randn(8, 4, 6)
    assert shd.constrain(x, ["batch", None, "model"]) is x
    y = torch.randn(8, 3)
    calls = []

    def fn(a, b):
        calls.append((a, b))
        return a.sum(-1), b * 2

    out = shd.shard_map_batch(fn, x, y)
    assert len(calls) == 1 and calls[0][0] is x and calls[0][1] is y
    assert torch.equal(out[0], x.sum(-1)) and torch.equal(out[1], y * 2)


def test_batch_axes_and_placements_of_a_tuple_entry():
    from torch.distributed.tensor import Replicate, Shard
    multi = shd.AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    assert shd.batch_axes(multi) == ("pod", "data")
    assert shd.batch_axes(shd.AbstractMesh((4, 4), ("data", "model"))) == ("data",)
    sh = shd.NamedSharding(multi, (("pod", "data"), None, "model"))
    assert sh.placements == (Shard(0), Shard(0), Shard(2))
    assert shd.NamedSharding(multi, ()).placements == (Replicate(),) * 3
    assert shd.NamedSharding(multi, (("data",), ())).spec == ("data", None)
