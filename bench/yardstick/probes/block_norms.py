"""``block_norms``: read the (m, n) operand, write one f32 per tile."""

from .. import kernel_bytes

MODULE, ATTR = "repro_torch.kernels.block_norms", "launch"


def note(args, kw, out):
    """(operand shape, itemsize, tile) of ``launch(x, block_shape)``."""
    return tuple(args[0].shape), args[0].element_size(), tuple(args[1])


def least_bytes(noted) -> int:
    (m, n), itemsize, (bh, bw) = noted
    return kernel_bytes.block_norms(m, n, bh, bw, itemsize)


def flops(noted) -> int:
    return 0
