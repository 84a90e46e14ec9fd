"""Logical-axis -> mesh-axis partitioning rules (``repro.sharding.rules``).

Every model's ``axes()`` returns a tree parallel to its params whose
leaves are tuples of logical axis names, one per dim (``("embed",
"mlp")``); this module turns them into partition specs for a mesh, with
the reference's divisibility fallback (a dim that does not divide evenly
over its mesh axes is replicated) and its rule that no mesh axis shards
two dims of one tensor.

A spec is a tuple with one entry per dim: None (replicated), a mesh axis
name, or a tuple of names, the entries of the reference's
``PartitionSpec``.  The rules read only the mesh's axis names and sizes,
so they take an :class:`AbstractMesh` as well as a ``DeviceMesh``: the
production (16, 16) and (2, 16, 16) meshes can be reasoned about on one
CPU.

Two modes:

- ``tp``       tensor-parallel only ("model" axis): inside the
               paper-faithful PHSFL round, where "pod"/"data" are the
               client axes and each client owns a full replica.
- ``fsdp_tp``  also shards the d_model ("embed") dim of the weights over
               the client axes (ZeRO-3 / FSDP style): the shared-server
               mode and serving.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

from repro_torch.utils.tree import axes_map

# canonical logical axis names used by the model zoo
LOGICAL_AXES = (
    "vocab",       # vocabulary dim
    "embed",       # d_model dim
    "mlp",         # d_ff dim
    "heads",       # query-head dim (fused heads*head_dim or head count)
    "kv_heads",    # kv-head count dim
    "head_dim",    # per-head feature dim
    "expert",      # MoE expert count dim
    "lru",         # RG-LRU width dim
    "stack",       # scanned-layer stack dim
    "conv",        # conv kernel spatial dims
)

# tensor-parallel rules: logical axis -> mesh axes
_TP_RULES = {
    "vocab": ("model",),
    "mlp": ("model",),
    "heads": ("model",),
    "expert": ("model",),
    "lru": ("model",),
}

# kv_heads shard over model only when the count divides (the divisibility
# check below applies to every rule alike)
_TP_OPTIONAL = {
    "kv_heads": ("model",),
}


@dataclass(frozen=True)
class AbstractMesh:
    """A mesh's axis names and sizes, with no process group."""
    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))


def as_abstract(mesh) -> AbstractMesh:
    """The names and sizes of an :class:`AbstractMesh` or a
    ``torch.distributed.device_mesh.DeviceMesh``."""
    if isinstance(mesh, AbstractMesh):
        return mesh
    return AbstractMesh(tuple(mesh.mesh_dim_names), tuple(mesh.shape))


def data_axes(mesh) -> tuple[str, ...]:
    """The mesh axes that play the client / batch role."""
    names = as_abstract(mesh).axis_names
    return tuple(a for a in ("pod", "data") if a in names)


def _axis_size(mesh: AbstractMesh, names: tuple[str, ...]) -> int:
    size = 1
    for n in names:
        size *= mesh.shape[n]
    return size


def spec_for(shape: tuple[int, ...], axes: tuple[Any, ...], mesh,
             mode: str = "tp") -> tuple:
    """The partition spec of one tensor given its logical axes."""
    if len(shape) != len(axes):
        raise ValueError(f"shape {shape} vs axes {axes}")
    mesh = as_abstract(mesh)
    used: set[str] = set()
    entries: list[Any] = []
    for dim, ax in zip(shape, axes):
        assigned = None
        candidates: tuple[str, ...] = ()
        if ax in _TP_RULES:
            candidates = _TP_RULES[ax]
        elif ax in _TP_OPTIONAL:
            candidates = _TP_OPTIONAL[ax]
        elif ax == "embed" and mode == "fsdp_tp":
            candidates = data_axes(mesh)
        if (candidates and not set(candidates) & used
                and all(c in mesh.axis_names for c in candidates)
                and dim % _axis_size(mesh, candidates) == 0):
            assigned = candidates if len(candidates) > 1 else candidates[0]
            used.update(candidates)
        entries.append(assigned)
    return tuple(entries)


def params_specs(params, axes_tree, mesh, mode: str = "tp"):
    """A params tree (tensors, or anything with ``.shape``: meta tensors
    will do) and its axes tree -> a tree of partition specs."""
    mesh = as_abstract(mesh)
    return axes_map(lambda p, a: spec_for(tuple(p.shape), a, mesh, mode),
                    params, axes_tree)


def add_client_axis(spec_tree, mesh):
    """Prefix every spec with the client axes (paper-faithful mode):
    per-client replicas carry a leading dim of pods x clients_per_pod,
    sharded over ("pod", "data")."""
    ca = data_axes(mesh)
    lead = ca if len(ca) > 1 else ca[0]
    if isinstance(spec_tree, dict):
        return {k: add_client_axis(v, mesh) for k, v in spec_tree.items()}
    return (lead, *spec_tree)


# ------------------------------------------------ a rank's block of a tree --
def _entry_axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def mesh_coordinate(mesh) -> dict[str, int]:
    """This rank's coordinate along each dim of a ``DeviceMesh``."""
    names = as_abstract(mesh).axis_names
    return dict(zip(names, mesh.get_coordinate()))


def block_index(entry, mesh, coord: dict[str, int]) -> tuple[int, int]:
    """(index, count) of the block of a dim sharded by ``entry`` that the
    rank at ``coord`` holds: the first axis of a tuple is the major one,
    as in a ``PartitionSpec``."""
    shape = as_abstract(mesh).shape
    idx, n = 0, 1
    for a in _entry_axes(entry):
        idx = idx * shape[a] + coord[a]
        n *= shape[a]
    return idx, n


def local_shape(shape: tuple[int, ...], spec: tuple, mesh) -> tuple:
    """A leaf's block shape under ``spec``."""
    sizes = as_abstract(mesh).shape
    out = []
    for dim, entry in zip(shape, spec):
        n = 1
        for a in _entry_axes(entry):
            n *= sizes[a]
        out.append(dim // n)
    return tuple(out)


def _is_spec(x) -> bool:
    return isinstance(x, tuple) and all(
        e is None or isinstance(e, (str, tuple)) for e in x)


def _spec_map(fn, tree, specs):
    if isinstance(tree, dict):
        return {k: _spec_map(fn, tree[k], specs[k]) for k in tree}
    if isinstance(tree, tuple):         # a recurrent cache's carry
        return tuple(_spec_map(fn, t, s) for t, s in zip(tree, specs))
    if not _is_spec(specs):
        raise ValueError(f"leaf meets spec subtree {specs!r}")
    return fn(tree, specs)


def spec_map(fn, spec_tree):
    """``fn`` over the specs of a spec tree (dicts of spec tuples)."""
    if isinstance(spec_tree, dict):
        return {k: spec_map(fn, v) for k, v in spec_tree.items()}
    return fn(spec_tree)


def shard_params(tree, spec_tree, mesh, coord: dict[str, int] | None = None):
    """The block of every leaf of a whole ``tree`` that the rank at
    ``coord`` holds (this rank of a ``DeviceMesh`` by default) under
    ``spec_tree`` (``params_specs``, ``input_specs``' specs): the
    counterpart of the reference's ``named_sharding`` for the weights
    carried across.  Blocks are contiguous copies."""
    coord = mesh_coordinate(mesh) if coord is None else coord

    def cut(x, spec):
        for d, entry in enumerate(spec):
            i, n = block_index(entry, mesh, coord)
            if n > 1:
                size = x.shape[d] // n
                x = x.narrow(d, i * size, size)
        return x.contiguous()

    return _spec_map(cut, tree, spec_tree)


def gather_params(tree, spec_tree, mesh):
    """The whole leaves from every rank's blocks: ``all_gather`` over the
    groups of each sharded dim, innermost axis first (the inverse of
    :func:`shard_params`, bit for bit).  A collective: every rank of
    ``mesh`` (a ``DeviceMesh``) calls it."""
    import torch
    import torch.distributed as dist

    def whole(x, spec):
        for d, entry in enumerate(spec):
            for a in reversed(_entry_axes(entry)):
                group = mesh.get_group(a)
                parts = [torch.empty_like(x)
                         for _ in range(dist.get_world_size(group))]
                dist.all_gather(parts, x.contiguous(), group=group)
                x = torch.cat(parts, dim=d)
        return x

    return _spec_map(whole, tree, spec_tree)


def client_split_dims(local_shape: tuple, whole_shape: tuple, spec: tuple,
                      mesh) -> list:
    """The (dim, entry) pairs of a leaf that hold this rank's block over
    the client dims ("pod" / "data"; ``fsdp_tp``'s "embed" dims): those
    whose spec entry names client axes only and whose local size is
    smaller than the whole's.  A leaf given whole yields none."""
    clients = set(data_axes(mesh))
    return [(d, e) for d, e in enumerate(spec)
            if e is not None and set(_entry_axes(e)) <= clients
            and local_shape[d] < whole_shape[d]]


def gather_dims(x, dims: list, mesh):
    """``x`` whole along ``dims`` (``client_split_dims``' pairs):
    ``all_gather`` over each entry's axes, innermost first, as
    :func:`gather_params` (outside autograd)."""
    from repro_torch.sharding.tensor_parallel import all_gather_dim
    for d, entry in dims:
        for a in reversed(_entry_axes(entry)):
            x = all_gather_dim(x, mesh.get_group(a), d)
    return x


def reduce_scatter_dims(g, dims: list, mesh):
    """The adjoint of :func:`gather_dims`: this rank's block of ``g``
    summed over the same axes (``reduce_scatter``, in the reverse
    order).  The gradient of a gathered leaf."""
    from repro_torch.sharding.tensor_parallel import reduce_scatter_dim
    for d, entry in reversed(dims):
        for a in _entry_axes(entry):
            g = reduce_scatter_dim(g, mesh.get_group(a), d)
    return g.contiguous()
