"""Roofline terms for one dry-run step on the H100 (``repro.launch.
roofline``).

    compute term    = flops / 989 TFLOP/s (dense bf16)
    memory term     = hbm_bytes / 3.35 TB/s (HBM3)
    collective term = coll_tp / model_link_bw(model dim)
                      + (coll_bytes - coll_tp) / 50 GB/s

The constants are the NVIDIA H100 SXM5's, from its data sheet (dense
bf16 tensor-core peak, i.e. the sparse figure halved; HBM3 bandwidth;
NVLink 4 at 900 GB/s both directions, 450 GB/s each), and the DGX H100
node's: 8 GPUs, each with its own ConnectX-7 InfiniBand NDR port (400
Gb/s = 50 GB/s a direction).  The mesh is laid out "model"-fastest, so a
node holds 8 consecutive "model" ranks, and the two kinds of collective
cross different links:

- the "model" dim (``coll_tp``): inside a node at a width up to 8, held
  to NVLink; at 16 its group spans two nodes.  NCCL splits a ring into
  channels, one through each of a node's 8 NICs, so the group's traffic
  between the nodes runs at 8 x 50 = 400 GB/s a GPU, below NVLink's 450
  (``model_link_bw``).
- the client dims ("data", "pod": the edge, global and FSDP bytes):
  every hop of their rings crosses nodes, and the 8 GPUs of a node run 8
  such rings at once, one NIC each, so each GPU's bytes go at its own
  NIC's 50 GB/s.

The terms themselves come from the analytic model (``launch/analytic``),
as in the reference.  Beside them each record keeps what tracing the
step counted, where the reference keeps its compiled HLO's numbers:

- ``traced_flops``: ``torch.utils.flop_counter.FlopCounterMode``'s total
  over one rank's step (the kernels' custom ops carry their own
  formulas).  Eager tracing counts each loop at its trip count, so the
  reference's "loop bodies counted once" caveat does not apply; the
  ratio to the analytic FLOPs is recorded, not asserted.
- the collectives: :class:`CollectiveRecorder`, a dispatch mode that
  records every ``c10d`` collective the step issues (its kind, its
  group's mesh dim, its output bytes), under the reference's keys.
- ``peak_memory_bytes``: ``MemTracker``'s peak, in place of XLA's
  ``memory_analysis()``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from torch.utils._python_dispatch import TorchDispatchMode

# NVIDIA H100 SXM5 (data sheet), per GPU
PEAK_FLOPS = 989e12          # dense bf16 tensor-core FLOP/s
HBM_BW = 3.35e12             # HBM3 bytes/s
NVLINK_BW = 450e9            # NVLink 4, bytes/s a direction
# DGX H100 node: 8 GPUs, one ConnectX-7 InfiniBand NDR port each
GPUS_PER_NODE = 8
NIC_BW = 400e9 / 8           # bytes/s a direction (400 Gb/s)


def model_link_bw(model_dim: int) -> float:
    """Bytes/s a GPU for the "model" dim's collectives: NVLink inside a
    node; across nodes the node's NICs, all of them, carry the group's
    ring channels."""
    if model_dim <= GPUS_PER_NODE:
        return NVLINK_BW
    return min(NVLINK_BW, GPUS_PER_NODE * NIC_BW)

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")

# c10d op -> (kind, where its output tensors are among the args)
_C10D_KINDS = {
    "allreduce_": ("all-reduce", 0),
    "allreduce_coalesced_": ("all-reduce", 0),
    "allgather_": ("all-gather", 0),
    "_allgather_base_": ("all-gather", 0),
    "allgather_into_tensor_coalesced_": ("all-gather", 0),
    "allgather_coalesced_": ("all-gather", 0),
    "reduce_scatter_": ("reduce-scatter", 0),
    "_reduce_scatter_base_": ("reduce-scatter", 0),
    "reduce_scatter_tensor_coalesced_": ("reduce-scatter", 0),
    "alltoall_": ("all-to-all", 0),
    "alltoall_base_": ("all-to-all", 0),
    "send": ("collective-permute", 0),
    "recv_": ("collective-permute", 0),
}


def _tensor_bytes(x) -> int:
    import torch
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_tensor_bytes(t) for t in x)
    return 0


def _group_name(args) -> str | None:
    import torch
    pg_type = torch._C._distributed_c10d.ProcessGroup
    for a in args:
        if isinstance(a, torch.ScriptObject):
            try:
                return pg_type.unbox(a).group_name
            except (RuntimeError, TypeError):
                continue
    return None


def empty_record() -> dict:
    out = {k: 0 for k in _COLLECTIVES}
    out["total"] = 0
    out["counts"] = {k: 0 for k in _COLLECTIVES}
    out["by_dim"] = {}
    return out


class CollectiveRecorder(TorchDispatchMode):
    """Records every ``c10d`` collective dispatched inside it.

    ``mesh`` (a ``DeviceMesh``) names each group by its mesh dim; a group
    of no dim of it is "other".  ``record`` holds the reference's keys
    (bytes by kind, "total", "counts" by kind) and "by_dim": {dim: {kind:
    bytes, "counts": {kind: n}}}.  Bytes are each call's output tensors'
    (the reference's per-device wire proxy; ring factors are not
    modelled)."""

    def __init__(self, mesh=None):
        super().__init__()
        self.dims = {}
        if mesh is not None:
            for d in mesh.mesh_dim_names:
                self.dims[mesh.get_group(d).group_name] = d
        self.record = empty_record()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace == "c10d":
            name = func._schema.name.split("::")[-1]
            if name in _C10D_KINDS:
                kind, at = _C10D_KINDS[name]
                self.add(kind, self.dims.get(_group_name(args), "other"),
                         _tensor_bytes(args[at]))
        return out

    def add(self, kind: str, dim: str, nbytes: int) -> None:
        r = self.record
        r[kind] += nbytes
        r["total"] += nbytes
        r["counts"][kind] += 1
        row = r["by_dim"].setdefault(dim, {**{k: 0 for k in _COLLECTIVES},
                                           "counts": {k: 0 for k in
                                                      _COLLECTIVES}})
        row[kind] += nbytes
        row["counts"][kind] += 1


@dataclass
class Roofline:
    """Roofline terms for one (arch, shape, mesh) combination.

    The primary terms (compute_s / memory_s / collective_s) come from the
    ANALYTIC model (launch/analytic.py), as in the reference.  The traced
    numbers are kept as traced_* fields: one rank's step as eager tracing
    counted it (every loop at its trip count), and the collective
    schedule it issued (counts per kind and mesh dim)."""
    arch: str
    shape: str
    mesh: str
    chips: int
    # analytic (per chip)
    flops: float
    hbm_bytes: float
    coll_bytes: float
    # traced (one rank)
    traced_flops: float = 0.0
    traced_coll_bytes: float = 0.0
    coll_detail: dict = field(default_factory=dict)
    analytic_detail: dict = field(default_factory=dict)
    model_flops: float = 0.0     # 6*N_active*D (global)
    peak_memory_bytes: float = 0.0
    model_dim: int = 1

    @property
    def compute_s(self) -> float:
        return self.flops / PEAK_FLOPS

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def collective_s(self) -> float:
        tp = self.analytic_detail.get("coll_tp", 0.0)
        return (tp / model_link_bw(self.model_dim)
                + (self.coll_bytes - tp) / NIC_BW)

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / (global analytic flops): how much of the compute is
        'useful' (catches remat/redundancy/frontend waste)."""
        total = self.flops * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def traced_flops_ratio(self) -> float:
        """Traced over analytic FLOPs a chip (recorded, not asserted)."""
        return self.traced_flops / self.flops if self.flops else 0.0

    def to_dict(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "flops_per_chip": self.flops,
            "hbm_bytes_per_chip": self.hbm_bytes,
            "collective_bytes_per_chip": self.coll_bytes,
            "traced_flops_per_chip": self.traced_flops,
            "traced_collective_bytes_per_chip": self.traced_coll_bytes,
            "traced_flops_over_analytic": self.traced_flops_ratio,
            "collective_detail": self.coll_detail,
            "analytic_detail": self.analytic_detail,
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "dominant": self.dominant,
            "model_flops": self.model_flops,
            "useful_flops_ratio": self.useful_flops_ratio,
            "peak_memory_bytes": self.peak_memory_bytes,
        }


def active_params(cfg) -> int:
    """Parameter count; for MoE, the *active* (top-k) parameter count.
    Counted on the meta device."""
    from repro_torch.core.phsfl import abstract_params
    from repro_torch.models.registry import build_model
    from repro_torch.utils.tree import path_leaves

    total = 0
    for path, s in path_leaves(abstract_params(build_model(cfg))):
        n = s.numel()
        if cfg.moe is not None and ("w_gate" in path or "w_up" in path
                                    or "w_down" in path):
            n = n * cfg.moe.top_k // cfg.moe.num_experts
        total += n
    return total


def model_flops_for(cfg, shape, kind: str) -> float:
    """6*N*D train / 2*N*D inference, D = tokens processed per step."""
    n = active_params(cfg)
    if kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    # decode: one token per sequence
    return 2.0 * n * shape.global_batch


def analyze(traced: dict, *, arch: str, shape, mesh_name: str, chips: int,
            kind: str, cfg, mesh_shape: dict | None = None,
            mode: str = "paper_faithful", attn_impl: str = "flash",
            param_mode: str = "fsdp_tp", agg_dtype_bytes: int = 4,
            tcfg=None) -> Roofline:
    """``traced``: {"flops": FlopCounterMode's total, "collectives": a
    :class:`CollectiveRecorder`'s record, "peak_bytes": MemTracker's
    peak} of one rank's step."""
    from repro_torch.launch.analytic import cost_for

    coll = traced.get("collectives") or empty_record()
    ac = cost_for(cfg, shape, mesh_shape or {}, mode=mode,
                  attn_impl=attn_impl, param_mode=param_mode,
                  agg_dtype_bytes=agg_dtype_bytes, tcfg=tcfg)
    return Roofline(arch=arch, shape=shape.name, mesh=mesh_name, chips=chips,
                    flops=ac.flops, hbm_bytes=ac.hbm_bytes,
                    coll_bytes=ac.coll_bytes,
                    traced_flops=float(traced.get("flops", 0.0)),
                    traced_coll_bytes=float(coll["total"]),
                    coll_detail=coll, analytic_detail=ac.detail,
                    model_flops=model_flops_for(cfg, shape, kind),
                    peak_memory_bytes=float(traced.get("peak_bytes", 0.0)),
                    model_dim=(mesh_shape or {}).get("model", 1))
