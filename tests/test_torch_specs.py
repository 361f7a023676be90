"""The port's shape cells against the reference's ``repro.launch.specs``.

* ``SHAPES`` and ``cell_applicable`` agree for every arch x shape;
* ``make_cell`` builds the train_4k cell of every arch on a (1, 1) mesh on
  the meta device, with one sharding per argument leaf, each argument a
  DTensor of its sharding's placements (the counterpart of the
  reference's ``test_make_cell_specs_have_shardings``);
* the name-aware ``_cache_shardings`` gives every cache leaf of every
  prefill and decode cell the reference's spec on the (16, 16) mesh, with
  the data axes on the batch dim past the stacked layer axes where the
  reference's rule takes a layer axis as long as the batch.
"""

import jax
import pytest
from jax.sharding import AbstractMesh as JaxAbstractMesh

from repro.dist import sharding as jsh
from repro.launch import specs as jspecs
from repro.models import config as jconfig
from repro.models import transformer as jtransformer
from repro_torch.dist import sharding as shd
from repro_torch.launch import dryrun, specs
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import get_arch, list_archs, transformer
from repro_torch.tree import leaves


@pytest.mark.parametrize("arch", list_archs())
def test_cell_applicable_matches_the_reference(arch):
    assert specs.SHAPES == jspecs.SHAPES
    for shape in specs.SHAPES:
        assert specs.cell_applicable(get_arch(arch), shape) == \
            jspecs.cell_applicable(jconfig.get_arch(arch), shape), shape


@pytest.fixture(scope="module")
def mesh11():
    """A (1, 1) mesh on a 1-rank fake process group, destroyed after."""
    with dryrun.fake_group(1):
        yield make_mesh((1, 1), ("data", "model"), device_type="cpu")


@pytest.mark.parametrize("arch", list_archs())
def test_make_cell_places_every_argument(mesh11, arch):
    cell = specs.make_cell(arch, "train_4k", mesh11, device="meta")
    args, shardings = leaves(cell.args), leaves(cell.in_shardings)
    assert len(shardings) == len(args)
    assert [n for n, _ in args] == [n for n, _ in shardings]
    for (name, x), (_, sh) in zip(args, shardings):
        assert x.device.type == "meta" and tuple(x.placements) == sh.placements
        assert len(sh.spec) == x.ndim, name
    tokens = cell.args[1]["tokens"]
    assert tuple(tokens.shape) == (256, 4096)
    assert cell.donate == (0,)


CACHE_MESH = ((16, 16), ("data", "model"))


@pytest.mark.parametrize("arch", list_archs())
def test_cache_shardings_match_the_reference(arch):
    cfg, jcfg = get_arch(arch), jconfig.get_arch(arch)
    jmesh, pmesh = JaxAbstractMesh(*CACHE_MESH), shd.AbstractMesh(*CACHE_MESH)
    n = 0
    for shape, info in specs.SHAPES.items():
        if info["kind"] == "train" or not specs.cell_applicable(cfg, shape)[0]:
            continue
        b, t = info["global_batch"], info["seq_len"]
        ring = info["kind"] == "decode" and cfg.window is not None \
            and shape == "long_500k"
        cache_len = cfg.window if ring else t
        enc_len = t // cfg.encoder_seq_divisor if cfg.family == "audio" else 1
        jc = jax.eval_shape(lambda: jtransformer.init_caches(
            jcfg, b, cache_len, enc_len=enc_len))
        flat, _ = jax.tree_util.tree_flatten_with_path(
            jspecs._cache_shardings(jc, jcfg, jmesh, b))
        want = {jsh._path_str(p): _batch_past_layers(tuple(s.spec), name_x)
                for (p, s), name_x in zip(flat, leaves(jc))}
        pc = transformer.init_caches(cfg, b, cache_len, enc_len=enc_len,
                                     device="meta")
        got = {name: s.spec for name, s in
               leaves(specs._cache_shardings(pc, cfg, pmesh, b))}
        assert got == want, shape
        n += 1
    assert n >= 1


def _batch_past_layers(spec, name_leaf):
    """The reference's spec of a cache leaf with its data axes on the
    leaf's batch dim: the reference's rule takes the first dim equal to
    the serve batch, which is a stacked layer axis where a stack is as
    long as the batch (phi3-mini-3.8b x prefill_32k: 32 layers, 32 rows),
    and the port takes the dim past the layer axes."""
    name, leaf = name_leaf
    base = specs.BATCH_FROM_END.get(name.rsplit("/", 1)[-1])
    data = ("data",)
    first = next((d for d, e in enumerate(spec)
                  if e == "data" or (isinstance(e, tuple) and e == data)),
                 None)
    if base is None or first is None or first == len(leaf.shape) - base:
        return spec
    spec = list(spec)
    spec[len(leaf.shape) - base], spec[first] = spec[first], None
    return tuple(spec)
