"""Abstract inputs, each a meta tensor with its partition spec beside it,
for every (architecture x input-shape x mesh) combination
(``repro.launch.input_specs``).  No allocation.

Batch layout per step kind:

  train   (PHSFL round)   {"tokens","labels"}: (C, k_local, micro, seq)
                          C = pods*clients_per_pod client replicas,
                          k_local local SGD steps fused per round call,
                          micro = global_batch / C / k_local.
  prefill                 {"tokens","labels"}: (B, S) — batch over data axes.
  decode                  token (B,1) + per-layer KV/state cache.

Modality stubs ([vlm]/[audio]): patch/frame embeddings appear here as
precomputed inputs — exactly the allowed frontend carve-out.

A spec is a tuple with one entry per dim (``sharding.rules``): None, a
mesh axis or a tuple of axes, the reference's ``PartitionSpec`` padded
with None to the tensor's rank.  The rules are the reference's.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig, TrainConfig
from repro_torch.launch.mesh import num_clients
from repro_torch.models.registry import Model
from repro_torch.sharding.rules import as_abstract, data_axes
from repro_torch.utils.tree import map_with_path, tree_map


@dataclass(frozen=True)
class Sharded:
    """A whole abstract input (``meta``: shape and dtype on the meta
    device) and its partition spec."""
    meta: torch.Tensor
    spec: tuple

    @property
    def shape(self) -> tuple:
        return tuple(self.meta.shape)

    @property
    def dtype(self):
        return self.meta.dtype


def metas(tree):
    """The meta tensors of a tree of :class:`Sharded`."""
    return tree_map(lambda s: s.meta, tree)


def specs(tree):
    """The specs of a tree of :class:`Sharded`."""
    return tree_map(lambda s: s.spec, tree)


def _dab(mesh):
    ca = data_axes(mesh)
    return ca if len(ca) > 1 else ca[0]


def _dab_size(mesh) -> int:
    shape = as_abstract(mesh).shape
    n = 1
    for a in data_axes(mesh):
        n *= shape[a]
    return n


def _sds(shape, dtype, *entries) -> Sharded:
    spec = tuple(entries) + (None,) * (len(shape) - len(entries))
    return Sharded(torch.empty(tuple(shape), dtype=dtype, device="meta"),
                   spec)


def _extras_specs(cfg: ModelConfig, lead_shape: tuple[int, ...], seq: int,
                  mesh, lead_spec):
    """Modality-stub inputs with the given leading batch dims/spec."""
    extras = {}
    dt = getattr(torch, cfg.dtype)
    if cfg.vlm is not None:
        extras["patch_embeds"] = _sds(
            lead_shape + (cfg.vlm.num_patch_tokens, cfg.d_model), dt,
            lead_spec)
        extras["positions3"] = _sds(lead_shape + (seq, 3), torch.int32,
                                    lead_spec)
    if cfg.encdec is not None:
        extras["source_embeds"] = _sds(
            lead_shape + (cfg.encdec.max_source_len, cfg.d_model), dt,
            lead_spec)
    return extras


# ------------------------------------------------------------- train -------
def train_batch_specs(cfg: ModelConfig, shape: ShapeConfig, mesh,
                      tcfg: TrainConfig):
    """Per-client-stacked batch for the paper-faithful PHSFL round."""
    C = num_clients(mesh)
    k = tcfg.local_steps_in_step
    micro = shape.global_batch // (C * k)
    assert micro >= 1, (shape.global_batch, C, k)
    lead = _dab(mesh)
    tok = _sds((C, k, micro, shape.seq_len), torch.int32, lead)
    batch = {"tokens": tok, "labels": tok}
    batch.update(_extras_specs(cfg, (C, k, micro), shape.seq_len, mesh, lead))
    return batch


def train_weight_specs(mesh):
    C = num_clients(mesh)
    a = _sds((C,), torch.float32, _dab(mesh))
    return a, a


# ----------------------------------------------------- prefill / decode ----
def prefill_batch_specs(cfg: ModelConfig, shape: ShapeConfig, mesh):
    ds = _dab_size(mesh)
    lead = _dab(mesh) if shape.global_batch % ds == 0 else None
    tok = _sds((shape.global_batch, shape.seq_len), torch.int32, lead)
    batch = {"tokens": tok, "labels": tok}
    batch.update(_extras_specs(cfg, (shape.global_batch,), shape.seq_len,
                               mesh, lead))
    return batch


def decode_token_specs(cfg: ModelConfig, shape: ShapeConfig, mesh):
    ds = _dab_size(mesh)
    lead = _dab(mesh) if shape.global_batch % ds == 0 else None
    tok = _sds((shape.global_batch, 1), torch.int32, lead)
    extras = {}
    if cfg.vlm is not None:
        extras["positions3"] = _sds((shape.global_batch, 1, 3), torch.int32,
                                    lead)
    return tok, extras


def scanned_prefixes(cfg: ModelConfig) -> set:
    """Top-level cache keys whose leaves lead with a repeats dim."""
    if cfg.encdec is not None:
        return {"self", "cross"}
    from repro_torch.models.transformer import compute_stages
    return {f"stage{si}" for si, st in enumerate(compute_stages(cfg))
            if st.which == "scan"}


def cache_specs(model: Model, shape: ShapeConfig, mesh,
                dtype=torch.bfloat16):
    """Sharded abstract decode cache.

    Rules: shard the batch dim over the data axes when divisible; for
    global_batch=1 (long_500k) shard the cache *length* dim instead; shard
    very wide state dims (>=1024) over 'model'; shard attention kv heads
    over 'model' when they divide it.
    """
    B = shape.global_batch
    S = shape.seq_len
    ds = _dab_size(mesh)
    dab = _dab(mesh)
    model_size = as_abstract(mesh).shape["model"]
    cache = model.init_cache(B, S, dtype=dtype, device="meta")
    scanned = scanned_prefixes(model.cfg)

    def leaf_spec(path, leaf):
        top = path.split("/")[0]
        off = 1 if top in scanned else 0
        entries = [None] * leaf.ndim
        shp = leaf.shape
        if B > 1 and B % ds == 0 and off < leaf.ndim and shp[off] == B:
            entries[off] = dab
        elif B == 1 and leaf.ndim > off + 1 and shp[off + 1] >= ds \
                and shp[off + 1] % ds == 0:
            entries[off + 1] = dab          # shard cache length (long_500k)
        # wide diagonal state dims over model axis
        if leaf.ndim >= off + 2 and shp[-1] >= 1024 \
                and shp[-1] % model_size == 0:
            entries[-1] = "model"
        # attention kv heads over model axis
        if leaf.ndim - off == 4 and shp[off + 2] % model_size == 0 \
                and shp[off + 2] > 1:
            entries[off + 2] = "model"
        return Sharded(leaf, tuple(entries))

    return map_with_path(leaf_spec, cache)
