"""``block_scatter``: read the ids and k whole tiles, write their elements
inside the base; a copy that is not in place also reads and writes the
base."""

from .. import kernel_bytes

MODULE, ATTR = "repro_torch.kernels.block_scatter", "launch"


def note(args, kw, out):
    """(base shape, itemsize, tile, ids, in place) of ``launch(base, ids,
    blocks, inplace=...)``; the ids are read once the device has
    finished."""
    return (tuple(args[0].shape), args[0].element_size(),
            tuple(args[2].shape[1:]), args[1], bool(kw.get("inplace")))


def least_bytes(noted) -> int:
    (m, n), itemsize, (bh, bw), ids, inplace = noted
    return kernel_bytes.block_scatter(m, n, bh, bw, itemsize,
                                      ids.reshape(-1).tolist(), inplace)


def flops(noted) -> int:
    return 0
