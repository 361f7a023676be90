"""The port's gradient-compression example against the reference's, on the
CPU: ``repro_torch.examples.grad_compression.run()`` from the reference's
initial state gives losses within ``1e-4`` of the reference example's
``run()`` over 5 steps, compressed and dense, and the same cross-pod wire
bytes.
"""

import dataclasses
import importlib.util
import os

import jax
import numpy as np
import pytest

from repro.models import get_arch as jget_arch
from repro.train import trainer as jtrainer
from repro_torch.examples import grad_compression
from repro_torch.train import trainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("compressed", [True, False],
                         ids=["compressed", "dense"])
def test_grad_compression_losses_match_the_reference_example(compressed):
    spec = importlib.util.spec_from_file_location(
        "reference_grad_compression",
        os.path.join(ROOT, "examples", "grad_compression.py"))
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    want, want_wire = ref.run(compressed, 5, 0.25)
    jcfg = jget_arch("granite-3-8b").reduced()
    state = trainer.state_from_numpy(jax.tree.map(
        np.asarray, jtrainer.init_compressed_state(jcfg, jax.random.key(0),
                                                   n_pods=2)), "cpu")
    got, wire = grad_compression.run(compressed, 5, 0.25, device="cpu",
                                     state=state)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    assert wire == pytest.approx(want_wire, rel=1e-6)
    assert dataclasses.asdict(jcfg)["dtype"] == "float32"
