"""``adamw``: one AdamW step of a leaf in place. It must read the
gradient's distinct elements once (the compressed step's mean is
broadcast over the pod axis with stride 0), read and write the param,
and read and write both f32 moments: 22 B an element with bf16 g and p,
24 B with f32 g. Memory-bound: its ~15 f32 operations an element take
under 4 % of its byte time even at the card's 67 TFLOP/s outside the
tensor cores, so none are counted."""

import math

MODULE, ATTR = "repro_torch.kernels.adamw", "launch"


def note(args, kw, out):
    """(g's distinct elements, g's itemsize, p's elements, p's, m's and
    v's itemsizes) of ``launch(g, p, m, v, scale, lr, b1c, b2c, ...)``."""
    g, p, m, v = args[:4]
    distinct = math.prod(s for s, st in zip(g.shape, g.stride()) if st != 0)
    return (distinct, g.element_size(), p.numel(), p.element_size(),
            m.element_size(), v.element_size())


def least_bytes(noted) -> int:
    g_n, g_size, n, p_size, m_size, v_size = noted
    return g_n * g_size + 2 * n * (p_size + m_size + v_size)


def flops(noted) -> int:
    return 0
