"""Mesh construction (``repro.launch.mesh``).

Axis roles:
    pod    - PHSFL edge servers (the CS-level aggregation domain),
             multi-pod only
    data   - clients within an edge server (the edge aggregation domain)
    model  - tensor parallelism inside one client's model replica

Each function returns a ``torch.distributed.device_mesh.DeviceMesh`` over
the default process group (whose world size must be the mesh's size) on
the device type it is given, or with ``abstract=True`` the
:class:`~repro_torch.sharding.rules.AbstractMesh` of the same names and
sizes, which the sharding rules take without a process group.  Nothing
here runs at import.
"""

from __future__ import annotations

from repro_torch.configs.base import MeshConfig
from repro_torch.sharding.rules import AbstractMesh, as_abstract


def make_mesh(shape: tuple[int, ...], axis_names: tuple[str, ...], *,
              device_type: str = "cuda", abstract: bool = False):
    """A mesh of ``shape`` named ``axis_names``.  The process group must
    exist (or ``torch.distributed``'s environment variables must name
    it); on the card, set the rank's device before the call, or the
    mesh picks one from ``LOCAL_RANK``."""
    if abstract:
        return AbstractMesh(tuple(axis_names), tuple(shape))
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axis_names))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda", abstract: bool = False):
    cfg = MeshConfig(multi_pod=multi_pod)
    return make_mesh(cfg.shape, cfg.axes, device_type=device_type,
                     abstract=abstract)


def make_alt_mesh(*, device_type: str = "cuda", abstract: bool = False):
    """The same 256 chips as (32, 8): more clients (or FSDP shards) and
    half the tensor-parallel width."""
    return make_mesh((32, 8), ("data", "model"), device_type=device_type,
                     abstract=abstract)


def make_debug_mesh(*, multi_pod: bool = False, device_type: str = "cpu",
                    abstract: bool = False):
    """The reference's small test mesh of 8 ranks."""
    shape = (2, 2, 2) if multi_pod else (4, 2)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type=device_type, abstract=abstract)


def num_chips(mesh) -> int:
    n = 1
    for s in as_abstract(mesh).sizes:
        n *= s
    return n


def num_clients(mesh) -> int:
    """Client slots: the product of the client-role axes."""
    shape = as_abstract(mesh).shape
    n = 1
    for a in ("pod", "data"):
        n *= shape.get(a, 1)
    return n
