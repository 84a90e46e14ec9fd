"""Step builders (``repro.launch.steps``): the (train / prefill / decode)
step functions with their abstract inputs, used by the dry run and the
card's checks.

Each builder takes the reference's arguments, with a
``torch.distributed`` ``DeviceMesh`` for the mesh, and returns a
:class:`StepBundle`: ``args`` are the whole abstract inputs (meta
tensors), ``specs`` their partition specs, and ``fn`` takes this rank's
block of each (:func:`rank_args` cuts them from whole values through
``sharding.rules.shard_params``).

- train: the paper-faithful PHSFL edge round (``core.phsfl.
  make_phsfl_round``), one client a rank of the pod x data dims, its
  replica split over "model"; or the shared-server step.
- prefill: the forward, last-position logits (this rank's vocabulary
  columns under tensor parallelism).
- decode: one ``decode_step`` over a ``seq_len``-deep cache; at batch 1
  the cache's length is split over the client dims
  (``input_specs.cache_specs``).

Serving's default ``param_mode="fsdp_tp"`` also shards the "embed" dims
over the client dims: ``fn`` gathers those leaves (``all_gather`` over
the client groups) at the step's start, then runs the tensor-parallel
layers; so does the shared-server step, whose body and head the
reference lays out by ``fsdp_tp`` too.  Every family runs at a "model"
dim above 1.  A decode step gathers the recurrent layers' states (RG-LRU,
mLSTM, sLSTM) whole over every dim but the batch's before the layers
run, and writes this rank's block of the new state back after them.

Optimizer states carry their parameter's spec (each rank updates its
block); the reference lays them out by the client axes alone and lets
GSPMD move them.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

import torch

from repro_torch.configs.base import (MLSTM, RGLRU, SLSTM, HierarchyConfig,
                                      ModelConfig, ShapeConfig, TrainConfig)
from repro_torch.core.phsfl import (abstract_params, build_optimizer,
                                    make_phsfl_round)
from repro_torch.launch import input_specs as ispec
from repro_torch.launch.input_specs import Sharded
from repro_torch.launch.mesh import num_clients
from repro_torch.models.registry import build_model
from repro_torch.sharding.rules import (as_abstract, data_axes,
                                        gather_params, params_specs,
                                        shard_params, spec_map)
from repro_torch.sharding.tensor_parallel import parallel_for
from repro_torch.utils.tree import tree_leaves, tree_map


@dataclass
class StepBundle:
    """A step function plus abstract example arguments and their specs."""
    fn: Callable
    args: tuple
    kind: str
    meta: dict
    specs: tuple = field(default=())


def _bundle(fn, sharded_args: tuple, kind: str, meta: dict) -> StepBundle:
    return StepBundle(fn=fn, args=tuple(ispec.metas(a) for a in sharded_args),
                      kind=kind, meta=meta,
                      specs=tuple(ispec.specs(a) for a in sharded_args))


def _sharded(metas, spec_tree):
    return tree_map(lambda m, s: Sharded(m, s), metas, spec_tree)


def _state_specs(state, pspec, lead=()):
    """An optimizer state's specs: a subtree shaped like the params takes
    their specs, any other leaf (the step count) is replicated."""
    out = {}
    for k, v in state.items():
        if isinstance(v, dict):
            out[k] = pspec
        else:
            out[k] = (*lead, *(None,) * (v.dim() - len(lead)))
    return out


def _client_gatherer(pspec, mesh):
    """The fsdp leaves' gather over the client dims (identity when no
    leaf is sharded over them)."""
    clients = set(data_axes(mesh))

    def client_only(spec):
        out = []
        for e in spec:
            axes = e if isinstance(e, tuple) else (e,)
            out.append(e if e is not None and set(axes) <= clients else None)
        return tuple(out)

    cspec = spec_map(client_only, pspec)
    if not any(e is not None for s in _spec_leaves(cspec) for e in s):
        return lambda p: p
    return lambda p: gather_params(p, cspec, mesh)


def _spec_leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _spec_leaves(v)
    else:
        yield tree


class _StateGatherer:
    """The recurrent layers' decode states (RG-LRU, mLSTM, sLSTM) made
    whole over every split dim but the batch's (``input_specs.
    cache_specs`` splits a wide state over "model", the mLSTM carry's
    rows by its kv-heads rule, and at batch 1 the heads or width over
    the client dims), and this rank's block of the new state written back
    in place.  The layers' tensor-parallel forms read and write whole
    states."""

    def __init__(self, keys, specs, mesh):
        self.keys, self.specs, self.mesh = keys, specs, mesh

    def __call__(self, cache):
        if not self.keys:
            return cache
        whole = {k: dict(v) for k, v in cache.items()}
        for (st, b), spec in zip(self.keys, self.specs):
            whole[st][b] = gather_params(cache[st][b], spec, self.mesh)
        return whole

    def write_back(self, cache, whole):
        for (st, b), spec in zip(self.keys, self.specs):
            block = shard_params(whole[st][b], spec, self.mesh)
            tree_map(lambda dst, src: dst.copy_(src), cache[st][b], block)
        return cache


def _state_gatherer(cfg: ModelConfig, cache, mesh) -> _StateGatherer:
    """A :class:`_StateGatherer` over the recurrent layers' cache blocks
    (``cache``: the :class:`Sharded` tree) whose specs split a dim other
    than the batch's."""
    from repro_torch.models.transformer import compute_stages
    keys, specs = [], []
    if cfg.encdec is None:
        kinds = cfg.layer_kinds()
        for si, st in enumerate(compute_stages(cfg)):
            batch = 1 if st.which == "scan" else 0
            for j, lid in enumerate(st.layer_ids):
                if kinds[lid] not in (RGLRU, MLSTM, SLSTM):
                    continue
                block = cache[f"stage{si}"][f"b{j}"]
                if any(e is not None for sh in tree_leaves(block)
                       for d, e in enumerate(sh.spec) if d != batch):
                    keys.append((f"stage{si}", f"b{j}"))
                    specs.append(tree_map(lambda sh: tuple(
                        None if d == batch else e
                        for d, e in enumerate(sh.spec)), block))
    return _StateGatherer(keys, specs, mesh)


# ----------------------------------------------------------- train ---------
def build_train_step(cfg: ModelConfig, shape: ShapeConfig, mesh,
                     tcfg: TrainConfig | None = None,
                     hcfg: HierarchyConfig | None = None) -> StepBundle:
    """The paper-faithful PHSFL edge round (with global sync on multi-pod)."""
    tcfg = tcfg or TrainConfig()
    hcfg = hcfg or HierarchyConfig()
    model = build_model(cfg)
    C = num_clients(mesh)
    multi = "pod" in as_abstract(mesh).axis_names

    round_ = make_phsfl_round(model, hcfg, tcfg, mesh, global_sync=multi)
    one = abstract_params(model)
    opt, _ = build_optimizer(model, tcfg, params=one)
    pshapes = abstract_params(model, stacked_clients=C)
    params = _sharded(pshapes, round_.params_spec)

    lead = ispec._dab(mesh)
    state = tree_map(lambda s: s.new_empty((C, *s.shape)), opt.init(one))
    opt_state = _sharded(state, _state_specs(state, round_.params_spec,
                                             (lead,)))
    batch = ispec.train_batch_specs(cfg, shape, mesh, tcfg)
    au, ab = ispec.train_weight_specs(mesh)
    return _bundle(round_.fn, (params, opt_state, batch, au, ab), "train",
                   {"clients": C, "local_steps": tcfg.local_steps_in_step,
                    "global_sync": multi, "mode": "paper_faithful"})


def build_shared_server_train_step(cfg: ModelConfig, shape: ShapeConfig,
                                   mesh, tcfg: TrainConfig | None = None,
                                   hcfg: HierarchyConfig | None = None
                                   ) -> StepBundle:
    """Beyond-paper shared-server (SFL-V2) step for the same shapes, laid
    out as the reference's: the body and head by ``fsdp_tp``, the client
    block stacked per client over the client dims and whole otherwise."""
    from repro_torch.core.phsfl import make_shared_server_step
    from repro_torch.core.split import part_masks, split_spec_for

    tcfg = tcfg or TrainConfig(shared_server=True)
    hcfg = hcfg or HierarchyConfig()
    model = build_model(cfg)
    C = num_clients(mesh)
    step = make_shared_server_step(model, hcfg, tcfg, mesh, C)

    shapes = abstract_params(model)
    masks = part_masks(shapes, split_spec_for(cfg))
    pspec = params_specs(shapes, model.axes(), mesh, mode="fsdp_tp")
    lead = ispec._dab(mesh)

    def stacked(mask_c, s, sp):
        if mask_c:  # client block: per-client, replicate inner dims
            return Sharded(s.new_empty((C, *s.shape)),
                           (lead, *(None,) * s.dim()))
        return Sharded(s, sp)

    params = tree_map(stacked, masks["client"], shapes, pspec)
    opt, _ = build_optimizer(model, tcfg, params=ispec.metas(params))
    state = opt.init(ispec.metas(params))
    opt_state = _sharded(state, _state_specs(state, ispec.specs(params)))

    # batch: (C, micro, seq) — one local step per call in this mode
    micro = shape.global_batch // C
    tok = ispec._sds((C, micro, shape.seq_len), torch.int32, lead)
    batch = {"tokens": tok, "labels": tok}
    batch.update(ispec._extras_specs(cfg, (C, micro), shape.seq_len, mesh,
                                     lead))
    return _bundle(step.fn, (params, opt_state, batch), "train",
                   {"clients": C, "mode": "shared_server"})


# ------------------------------------------------------ prefill / decode ---
def _serving_params(model, mesh, param_mode: str):
    shapes = abstract_params(model)
    pspec = params_specs(shapes, model.axes(), mesh, mode=param_mode)
    return _sharded(shapes, pspec), pspec


def build_prefill_step(cfg: ModelConfig, shape: ShapeConfig, mesh, *,
                       param_mode: str = "fsdp_tp") -> StepBundle:
    model = build_model(cfg)
    params, pspec = _serving_params(model, mesh, param_mode)
    batch = ispec.prefill_batch_specs(cfg, shape, mesh)
    gather = _client_gatherer(pspec, mesh)
    par = parallel_for(mesh)

    def prefill_fn(params, batch):
        params = gather(params)
        hidden, _ = model.apply(params, batch, remat=False, par=par)
        # last-position logits (what serving returns after prefill)
        return model.logits(params, hidden[:, -1:, :], par=par)

    return _bundle(prefill_fn, (params, batch), "prefill",
                   {"mode": "serving", "param_mode": param_mode})


def build_decode_step(cfg: ModelConfig, shape: ShapeConfig, mesh, *,
                      param_mode: str = "fsdp_tp") -> StepBundle:
    model = build_model(cfg)
    params, pspec = _serving_params(model, mesh, param_mode)
    tok, extras = ispec.decode_token_specs(cfg, shape, mesh)
    cache = ispec.cache_specs(model, shape, mesh)
    index = Sharded(torch.empty((), dtype=torch.int32, device="meta"), ())
    split = shape.global_batch == 1 and ispec._dab_size(mesh) > 1
    gather = _client_gatherer(pspec, mesh)
    states = _state_gatherer(cfg, cache, mesh)
    par = parallel_for(mesh, cache_split=split, cache_len=shape.seq_len)

    def decode_fn(params, token, cache, index, positions3=None):
        whole = states(cache)
        logits, _ = model.decode_step(gather(params), token, whole,
                                      int(index), positions3=positions3,
                                      par=par)
        return logits, states.write_back(cache, whole)

    args = (params, tok, cache, index)
    if extras:
        args += (extras["positions3"],)
    return _bundle(decode_fn, args, "decode",
                   {"mode": "serving", "cache_len": shape.seq_len,
                    "param_mode": param_mode, "cache_split": split})


def build_step(cfg: ModelConfig, shape: ShapeConfig, mesh, *,
               train_mode: str = "paper_faithful",
               serve_param_mode: str = "fsdp_tp",
               tcfg: TrainConfig | None = None) -> StepBundle:
    if shape.kind == "train":
        if train_mode == "shared_server":
            return build_shared_server_train_step(cfg, shape, mesh, tcfg)
        return build_train_step(cfg, shape, mesh, tcfg)
    if shape.kind == "prefill":
        return build_prefill_step(cfg, shape, mesh,
                                  param_mode=serve_param_mode)
    if shape.kind == "decode":
        return build_decode_step(cfg, shape, mesh,
                                 param_mode=serve_param_mode)
    raise ValueError(shape.kind)


# ------------------------------------------------------ a rank's inputs ----
def rank_args(bundle: StepBundle, whole: tuple, mesh) -> tuple:
    """This rank's block of whole inputs for ``bundle.fn``: each argument
    a tree (numpy arrays or tensors, as ``bundle.args`` is laid out; a
    Python int for the decode index, or None, passes as it is) cut by
    ``bundle.specs`` from this rank's coordinates in ``mesh``."""
    from repro_torch.convert import params_from_numpy
    out = []
    for arg, spec in zip(whole, bundle.specs):
        if arg is None or isinstance(arg, int):
            out.append(arg)
            continue
        t = tree_map(lambda a: a if isinstance(a, torch.Tensor) else
                     params_from_numpy(a, "cpu"), arg)
        out.append(shard_params(t, spec, mesh))
    return tuple(out)
