"""Production mesh construction, the port of ``repro.launch.mesh``.

Functions, not module-level constants: importing this module touches no
process group. Each builds a ``DeviceMesh`` over the default process group,
which the caller has initialised with as many ranks as the mesh has
devices (a real NCCL group, or the ``fake`` backend that stands one
process for one rank of a larger mesh, as :mod:`.dryrun` does).
"""

from __future__ import annotations

from typing import Sequence

PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """The (16, 16) mesh of one pod, or (2, 16, 16) over two."""
    shape, axes = PRODUCTION[multi_pod]
    return make_mesh(shape, axes, device_type=device_type)


def make_mesh(shape: Sequence[int], axes: Sequence[str], *,
              device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` with dim names ``axes`` on
    ``device_type`` devices."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))
