"""Per-super-block remat in the port (``repro_torch.models.transformer``).

For one reduced config of each family (``dense``, ``moe``, ``vlm``,
``hybrid``, ``ssm``, ``audio``), in f32 on the CPU:

* the loss and every gradient leaf under each of the four
  ``remat_policy`` values equal, byte for byte, the same step under
  ``everything_saveable`` (no checkpoint): a recomputed op on the CPU gives
  the same bits;
* each policy does what its name says: while autograd records, every
  super-block and encoder layer runs under ``torch.utils.checkpoint``
  (counted), and the backward pass recomputes the matmuls a policy does
  not keep (``aten.mm`` / ``addmm`` and ``bmm`` / ``baddbmm`` counted in
  the backward pass); prefill writes its caches with no checkpoint;
* the port's loss and gradients with remat agree with the JAX ``loss_fn``
  under its ``jax.checkpoint`` at the models' ``rtol = atol = 1e-4``;
  zamba2's shared attention, applied once per super-block and
  rematerialised each time, is among the leaves compared.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.models import get_arch as jget_arch
from repro.models import transformer as jt
from repro_torch.models import get_arch
from repro_torch.models import transformer as tt
from repro_torch.train import trainer
from repro_torch.tree import leaves, params_from_numpy, rebuild

CPU = "cpu"
FAMILIES = {"dense": "granite-3-8b", "moe": "granite-moe-1b-a400m",
            "vlm": "llama-3.2-vision-11b", "hybrid": "zamba2-2.7b",
            "ssm": "xlstm-1.3b", "audio": "whisper-tiny"}
POLICIES = ["nothing_saveable", "dots_saveable",
            "dots_with_no_batch_dims_saveable", "everything_saveable"]
T = 16   # two ssm chunks of the reduced configs
MM = {torch.ops.aten.mm.default, torch.ops.aten.addmm.default}
BMM = {torch.ops.aten.bmm.default, torch.ops.aten.baddbmm.default}


def cfg_for(name, policy="nothing_saveable"):
    return dataclasses.replace(get_arch(name).reduced(), remat_policy=policy)


def batch_np(cfg, seed=3):
    """tokens, next-token labels (the last two masked) and the family's
    stub-frontend input, from a seed."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab_size, (2, T)).astype(np.int32)
    lab = np.concatenate([tok[:, 1:], np.full((2, 1), -1, np.int32)], 1)
    lab[:, T - 2:] = -1
    b = {"tokens": tok, "labels": lab}
    if cfg.family == "vlm":
        b["image_embeds"] = rng.standard_normal(
            (2, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)
    if cfg.family == "audio":
        b["encoder_frames"] = rng.standard_normal(
            (2, T // cfg.encoder_seq_divisor, cfg.d_model)).astype(np.float32)
    return b


def ref_params(cfg, seed=4):
    """(the reference's params, the port's copy on the CPU)."""
    jcfg = dataclasses.replace(jget_arch(cfg.name).reduced(),
                               remat_policy=cfg.remat_policy)
    p = jt.init_params(jcfg, jax.random.key(seed))
    return jcfg, p, params_from_numpy(jax.tree.map(np.asarray, p), CPU)


def port_step(cfg, params, b):
    """(total, loss, grads) of the port's ``loss_fn``."""
    tb = {k: torch.as_tensor(v) for k, v in b.items()}
    total, m, grads = trainer._grads(lambda p: tt.loss_fn(p, cfg, tb), params)
    return total, m["loss"].detach(), grads


class CountOps(TorchDispatchMode):
    """Counts the matmul ops dispatched while it is on."""

    def __init__(self):
        super().__init__()
        self.mm = self.bmm = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.mm += func in MM
        self.bmm += func in BMM
        return func(*args, **(kwargs or {}))


def backward_matmuls(cfg, params, b):
    """(mm, bmm) ops run by the backward pass of ``loss_fn`` (gradients and
    the recomputed forward of each rematerialised block)."""
    tb = {k: torch.as_tensor(v) for k, v in b.items()}
    flat = [p.detach().requires_grad_() for _, p in leaves(params)]
    with torch.enable_grad():
        total = tt.loss_fn(rebuild(params, iter(flat)), cfg, tb)[0]
        with CountOps() as c:
            torch.autograd.grad(total, flat)
    return c.mm, c.bmm


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("family", list(FAMILIES))
def test_every_policy_gives_the_unrematerialised_grads(family, policy):
    name = FAMILIES[family]
    cfg = cfg_for(name, policy)
    _, _, params = ref_params(cfg)
    b = batch_np(cfg)
    total, loss, grads = port_step(cfg, params, b)
    w_total, w_loss, w_grads = port_step(
        cfg_for(name, "everything_saveable"), params, b)
    assert torch.equal(total, w_total) and torch.equal(loss, w_loss)
    g, w = leaves(grads), leaves(w_grads)
    assert [n for n, _ in g] == [n for n, _ in w]
    bad = [n for (n, x), (_, y) in zip(g, w) if not torch.equal(x, y)]
    assert not bad, bad


@pytest.mark.parametrize("family", list(FAMILIES))
def test_policies_recompute_what_they_do_not_keep(family, monkeypatch):
    """Checkpoints: one per super-block and encoder layer under a remat
    policy (plus the cross-entropy chunk), none under
    ``everything_saveable`` and none in a prefill. Backward matmuls:
    ``nothing_saveable`` recomputes every forward mm and bmm,
    ``dots_with_no_batch_dims_saveable`` only the bmm, ``dots_saveable``
    neither."""
    name = FAMILIES[family]
    calls = []
    real = tt.checkpoint

    def counting(fn, *args, **kw):
        calls.append(getattr(fn, "__name__", "?"))
        return real(fn, *args, **kw)

    monkeypatch.setattr(tt, "checkpoint", counting)
    base = cfg_for(name)
    n_super, _ = tt.superblock_plan(base)
    _, _, params = ref_params(base)
    b = batch_np(base)
    mms = {}
    for policy in POLICIES:
        cfg = cfg_for(name, policy)
        calls.clear()
        mms[policy] = backward_matmuls(cfg, params, b)
        blocks = [c for c in calls if c != "_ce_chunk"]
        want = 0 if policy == "everything_saveable" else \
            n_super + cfg.n_encoder_layers
        assert len(blocks) == want, (policy, calls)
        assert calls.count("_ce_chunk") == 1
    (mm_n, bmm_n), (mm_d, bmm_d), (mm_nb, bmm_nb), (mm_e, bmm_e) = (
        mms[p] for p in POLICIES)
    assert mm_n > mm_e and mm_d == mm_e and mm_nb == mm_e
    assert bmm_n > bmm_e and bmm_d == bmm_e and bmm_nb == bmm_n

    # prefill and decode write their caches in place, outside any checkpoint
    calls.clear()
    cfg = cfg_for(name)
    grad_params = rebuild(params, iter(
        [p.detach().requires_grad_() for _, p in leaves(params)]))
    extra = {k: torch.as_tensor(v[:1]) for k, v in b.items()
             if k not in ("tokens", "labels")}
    caches = tt.init_caches(cfg, 1, T, enc_len=T // cfg.encoder_seq_divisor,
                            device=CPU)
    with torch.enable_grad():
        tt.prefill(grad_params, cfg, torch.as_tensor(b["tokens"][:1]),
                   caches, **extra)
    assert calls == []


@pytest.mark.parametrize("family", list(FAMILIES))
def test_remat_loss_and_grads_match_reference(family):
    """The port under ``nothing_saveable`` against ``jax.value_and_grad``
    of the reference's ``loss_fn`` (its super-blocks under
    ``jax.checkpoint`` with the same policy), ``rtol = atol = 1e-4``."""
    cfg = cfg_for(FAMILIES[family])
    jcfg, jparams, params = ref_params(cfg)
    b = batch_np(cfg)
    (jtotal, jm), jgrads = jax.value_and_grad(
        lambda p: jt.loss_fn(p, jcfg, {k: jnp.asarray(v) for k, v in b.items()}),
        has_aux=True)(jparams)
    total, loss, grads = port_step(cfg, params, b)
    np.testing.assert_allclose(float(total), float(jtotal), rtol=1e-4)
    np.testing.assert_allclose(float(loss), float(jm["loss"]), rtol=1e-4)
    want = leaves(jax.tree.map(np.asarray, jgrads))
    got = leaves(grads)
    assert [n for n, _ in got] == [n for n, _ in want]
    for (n, g), (_, w) in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-4,
                                   err_msg=n)
    if family == "hybrid":
        shared = [g for n, g in got if n.startswith("shared_attn/")]
        assert shared and all(float(g.abs().max()) > 0 for g in shared)
