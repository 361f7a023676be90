"""``block_gather``: read the ids and the tiles' elements inside the
operand, write k whole tiles."""

from .. import kernel_bytes

MODULE, ATTR = "repro_torch.kernels.block_gather", "launch"


def note(args, kw, out):
    """(operand shape, itemsize, tile, ids) of ``launch(x, ids,
    block_shape)``; the ids are read once the device has finished."""
    return tuple(args[0].shape), args[0].element_size(), tuple(args[2]), args[1]


def least_bytes(noted) -> int:
    (m, n), itemsize, (bh, bw), ids = noted
    return kernel_bytes.block_gather(m, n, bh, bw, itemsize,
                                     ids.reshape(-1).tolist())


def flops(noted) -> int:
    return 0
