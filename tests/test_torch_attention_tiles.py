"""Prefill attention in query tiles against the whole masked softmax.

Where the f32 scores would pass ``attention.ATTN_TILE_BYTES`` (a train_4k
cell), ``prefill_attention`` runs ``chunk_q`` query rows at a time, each
tile recomputed in the backward pass. Here the bound is set to 0 so small
shapes take the tiled path: the output and the gradients of q, k and v
equal the untiled call's (each row's softmax is whole in both), for
causal, windowed and cross-attention shapes, GQA and ragged last tiles,
within f32 rounding (the tiles' matmuls may sum in another order); without
autograd the tiles run plain.
"""

import pytest
import torch

from repro_torch.models import attention

# the scores are f32 on both sides; the tiles' matmuls may sum in another
# order than the whole block's
RTOL, ATOL = 1e-5, 1e-6
CASES = {"causal": dict(t=40, s=40, causal=True, window=None),
         "window": dict(t=37, s=37, causal=True, window=9),
         "cross": dict(t=29, s=13, causal=False, window=None)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_tiles_equal_the_whole_softmax(case, monkeypatch):
    c = CASES[case]
    gen = torch.Generator().manual_seed(len(case))
    q = torch.randn(2, c["t"], 4, 8, generator=gen, dtype=torch.float32)
    k = torch.randn(2, c["s"], 2, 8, generator=gen, dtype=torch.float32)
    v = torch.randn(2, c["s"], 2, 8, generator=gen, dtype=torch.float32)
    g = torch.randn(2, c["t"], 4, 8, generator=gen, dtype=torch.float32)

    def run(chunk_q):
        xs = [x.clone().requires_grad_() for x in (q, k, v)]
        out = attention.prefill_attention(*xs, causal=c["causal"],
                                          window=c["window"], chunk_q=chunk_q)
        grads = torch.autograd.grad(out, xs, g)
        return out.detach(), grads

    whole, whole_g = run(None)
    monkeypatch.setattr(attention, "ATTN_TILE_BYTES", 0)
    tiled, tiled_g = run(8)
    torch.testing.assert_close(tiled, whole, rtol=RTOL, atol=ATOL)
    for a, b in zip(tiled_g, whole_g):
        torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL)
    with torch.no_grad():
        plain = attention.prefill_attention(q, k, v, causal=c["causal"],
                                            window=c["window"], chunk_q=8)
    torch.testing.assert_close(plain, whole, rtol=RTOL, atol=ATOL)
