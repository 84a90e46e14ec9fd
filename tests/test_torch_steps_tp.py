"""Port parity for the step builders under tensor parallelism
(``repro_torch.launch.steps``, ``sharding.tensor_parallel``) against the
reference's ``build_step`` on a (data 2, model 2) mesh.

- The reference runs in one subprocess on four fake CPU devices, on a
  mesh of Auto axes (its builders fail on jax 0.9's Explicit default:
  R7 in ROADMAP.md), from its own initial parameters: for reduced
  gemma3-12b, mistral-large-123b, command-r-plus-104b, qwen2-vl-7b (with
  its patch embeddings and ``positions3``) and gemma3-12b with one kv
  head (k and v replicated, so each rank picks the kv head its query
  heads read), the prefill step (last-position logits), one decode step
  over a random cache (logits and the written cache) and the
  paper-faithful train round (two clients weighted 0.5 each, two local
  steps, remat "full": params, optimizer state, loss); then gemma3-12b's
  decode at global batch 1, whose cache length is split over "data" (a
  ring of the sliding window spanning both slices), and the
  shared-server step for gemma3-12b and its one-kv-head variant (two
  clients, one a "data" rank; the body and head laid out by
  ``fsdp_tp``, gathered over "data" and their gradients reduce-scattered
  back, besides the whole leaves' sums over "model"), whose bundle's
  specs are written beside its outputs.  Its sharded outputs are read
  through ``np.asarray`` (R6).
- The port runs the same steps on four gloo ranks on the CPU (one
  spawn, one intra-op thread a rank) from the same numpy inputs, each
  rank given its block (``steps.rank_args``); the outputs are gathered
  by their specs (``sharding.rules.gather_params``).  Every rank also
  checks ``gather_params(shard_params(p)) == p`` bit for bit, and that
  olmoe-1b-7b (the MoE) builds every step kind at model 2.

``run_cases``, ``port_cases`` and the checks are shared with the other
families' files (``test_torch_steps_tp_{moe,recurrent,encdec}.py``).

Tolerance: 2e-5 in float32 (``tests/test_kernels.py:34``), relative to
each leaf's largest magnitude where that exceeds 1; tensor parallelism's
partial sums change the order of additions, so bit-equality is not
expected.  A train step's parameters are also held on their update
(after - before), within 2e-5 of the update's largest magnitude plus
one ulp of the leaf's largest value: at the paper's learning rate the
update is ~1e-4 of a weight, far below the limit on the weights
themselves, so only this check sees a gradient that misses its sum over
"model".
"""

import contextlib
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
TOL = 2e-5
ARCHS = ("gemma3-12b", "mistral-large-123b", "command-r-plus-104b",
         "qwen2-vl-7b", "gemma3-12b-kv1")
SHAPES = {"prefill": ("p", 32, 4, "prefill"),
          "decode": ("d", 16, 4, "decode"),
          "train": ("t", 32, 8, "train"),
          "decode_b1": ("d1", 128, 1, "decode"),
          "shared_server": ("t", 32, 8, "train")}
INDEX = {"decode": 9, "decode_b1": 100}
# the cases each arch runs: decode at batch 1 and the shared-server step
# (two clients, one on each "data" rank, a shared body and head) for
# gemma3-12b, and the latter with its kv head replicated
ONLY = {"decode_b1": ("gemma3-12b",),
        "shared_server": ("gemma3-12b", "gemma3-12b-kv1")}
# the train steps' TrainConfig by arch: gemma3-12b at the defaults (remat
# "full", whose recompute issues the "model" group's collectives again),
# the others without remat (the reference's compile is the file's cost)
TRAIN_KW = {"gemma3-12b": {}}
BF16_TOL = 2e-2     # tests/test_kernels.py:34: a bf16 cache slot's rounding

_REFERENCE = r"""
import dataclasses, json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
from repro.configs.base import ShapeConfig, TrainConfig
from repro.configs.registry import get_arch
from repro.core import init_stacked_params, build_optimizer
from repro.core.phsfl import init_shared_server_params
from repro.launch.mesh import set_mesh
from repro.launch.steps import build_step
from repro.models import build_model
from repro.utils.tree import map_with_path
ARCHS, SHAPES, INDEX, TRAIN_KW, ONLY = json.loads(sys.argv[2])
mesh = jax.make_mesh((2, 2), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
out = {}

def f32(x):
    a = np.asarray(x)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a

def put(prefix, tree):
    map_with_path(lambda p, x: out.__setitem__(f"{prefix}/{p}", f32(x)),
                  tree)

def cfg_of(name):
    if name.endswith("-kv1"):
        return dataclasses.replace(get_arch(name[:-4]).reduced(),
                                   num_kv_heads=1)
    if name[-3:] not in ("-e8", "-l3", "-h1"):
        return get_arch(name).reduced()
    cfg = get_arch(name[:-3]).reduced()
    if name.endswith("-e8"):
        return dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, num_experts=8, top_k=2))
    if name.endswith("-l3"):
        return dataclasses.replace(cfg, num_layers=3)
    return dataclasses.replace(cfg, xlstm=dataclasses.replace(
        cfg.xlstm, num_heads=1))

def spec_json(tree):
    return json.dumps({p: [list(e) if isinstance(e, tuple) else e
                           for e in s.sharding.spec]
                       for p, s in flat_paths(tree)})

def flat_paths(tree):
    got = []
    map_with_path(lambda p, s: got.append((p, s)), tree)
    return got

def inputs(args, seed):
    rng = np.random.default_rng(seed)
    def one(path, s):
        if jnp.issubdtype(s.dtype, jnp.integer):
            hi = 16 if "positions3" in path else 500
            return rng.integers(0, hi, size=s.shape).astype(np.int32)
        return rng.normal(size=s.shape).astype(np.float32)
    return map_with_path(one, args)

def placed(vals, args):
    return jax.tree.map(lambda v, s: jax.device_put(
        jnp.asarray(v).astype(s.dtype), s.sharding), vals, args)

for arch in ARCHS:
    cfg = cfg_of(arch)
    model = build_model(cfg)
    one = model.init(jax.random.PRNGKey(0))
    put(f"{arch}/init", one)
    for kind, sh in SHAPES.items():
        if arch not in ONLY.get(kind, ARCHS):
            continue
        shape = ShapeConfig(*sh)
        tcfg = TrainConfig(**TRAIN_KW.get(arch, {"remat": False}),
                           shared_server=kind == "shared_server")
        with set_mesh(mesh):
            b = build_step(cfg, shape, mesh, train_mode=(
                "shared_server" if kind == "shared_server"
                else "paper_faithful"), tcfg=tcfg)
            if kind == "shared_server":
                out[f"{arch}/{kind}/specs/params"] = np.asarray(
                    spec_json(b.args[0]))
                out[f"{arch}/{kind}/specs/batch"] = np.asarray(
                    spec_json(b.args[2]))
                params = init_shared_server_params(
                    model, jax.random.PRNGKey(0), 2)
                opt, _ = build_optimizer(model, tcfg)
                state = opt.init(params)
                batch = inputs(b.args[2], 6)
                put(f"{arch}/{kind}/in/batch", batch)
                p, s, m = jax.jit(b.fn)(
                    placed(jax.tree.map(np.asarray, params), b.args[0]),
                    state, placed(batch, b.args[2]))
                put(f"{arch}/{kind}/out/params", p)
                put(f"{arch}/{kind}/out/state", s)
                out[f"{arch}/{kind}/out/loss"] = np.asarray(m["loss"])
            elif kind == "train":
                C = 2
                params = init_stacked_params(model, jax.random.PRNGKey(0), C)
                opt, _ = build_optimizer(model, tcfg)
                s1 = opt.init(jax.tree.map(lambda x: x[0], params))
                state = jax.tree.map(lambda x: jnp.broadcast_to(
                    x[None], (C,) + x.shape), s1)
                batch = inputs(b.args[2], 1)
                au = np.asarray([0.5, 0.5], np.float32)
                ab = np.asarray([0.5, 0.5], np.float32)
                put(f"{arch}/{kind}/in/batch", batch)
                args = (placed(jax.tree.map(np.asarray, params), b.args[0]),
                        placed(jax.tree.map(np.asarray, state), b.args[1]),
                        placed(batch, b.args[2]), placed(au, b.args[3]),
                        placed(ab, b.args[4]))
                p, s, m = jax.jit(b.fn)(*args)
                put(f"{arch}/{kind}/out/params", p)
                put(f"{arch}/{kind}/out/state", s)
                out[f"{arch}/{kind}/out/loss"] = np.asarray(m["loss"])
            elif kind == "prefill":
                batch = inputs(b.args[1], 2)
                put(f"{arch}/{kind}/in/batch", batch)
                lg = jax.jit(b.fn)(placed(jax.tree.map(np.asarray, one),
                                          b.args[0]), placed(batch,
                                                             b.args[1]))
                out[f"{arch}/{kind}/out/logits"] = np.asarray(lg)
            else:
                tok = inputs(b.args[1], 3)
                cache = inputs(b.args[2], 4)
                put(f"{arch}/{kind}/in/token", {"t": tok})
                put(f"{arch}/{kind}/in/cache", cache)
                rest = ()
                if len(b.args) > 4:
                    pos = inputs(b.args[4], 5)
                    put(f"{arch}/{kind}/in/positions3", {"t": pos})
                    rest = (placed(pos, b.args[4]),)
                lg, c = jax.jit(b.fn)(
                    placed(jax.tree.map(np.asarray, one), b.args[0]),
                    placed(tok, b.args[1]), placed(cache, b.args[2]),
                    jnp.asarray(INDEX[kind], jnp.int32), *rest)
                out[f"{arch}/{kind}/out/logits"] = np.asarray(lg)
                put(f"{arch}/{kind}/out/cache", c)
np.savez(sys.argv[1], **out)
"""


def _unflatten(flat: dict, prefix: str) -> dict:
    tree = {}
    for key, a in flat.items():
        if not key.startswith(prefix + "/"):
            continue
        *dirs, leaf = key[len(prefix) + 1:].split("/")
        node = tree
        for d in dirs:
            node = node.setdefault(d, {})
        node[leaf] = np.array(a)
    return tree


def _cfg(name):
    import dataclasses
    from repro_torch.configs.registry import get_arch
    if name.endswith("-kv1"):
        return dataclasses.replace(get_arch(name[:-4]).reduced(),
                                   num_kv_heads=1)
    return variant(get_arch, name, dataclasses)


def variant(get_arch, name, dataclasses):
    """An arch's ``reduced()`` config, or a variant named by a suffix:
    "-e8" 8 experts top-2 (the MoE), "-l3" 3 layers (recurrentgemma's
    whole pattern), "-h1" one xLSTM head (so it does not divide the
    "model" dim).  The reference script carries the same table."""
    if name[-3:] not in ("-e8", "-l3", "-h1"):
        return get_arch(name).reduced()
    cfg = get_arch(name[:-3]).reduced()
    if name.endswith("-e8"):
        return dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, num_experts=8, top_k=2))
    if name.endswith("-l3"):
        return dataclasses.replace(cfg, num_layers=3)
    return dataclasses.replace(cfg, xlstm=dataclasses.replace(
        cfg.xlstm, num_heads=1))


def _flat(tree) -> dict:
    from repro_torch.utils.tree import path_leaves
    return {p: t.detach().to(torch.float32).numpy()
            for p, t in path_leaves(tree)}


def _spec_lists(tree) -> dict:
    """A spec tree as the reference's ``spec_json`` writes it: each leaf's
    entries as lists, the trailing replicated dims dropped (a
    ``PartitionSpec`` may leave them out)."""
    from repro_torch.sharding.rules import _is_spec
    out = {}

    def walk(t, pre):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, f"{pre}{k}/")
            return
        assert _is_spec(t), t
        e = [list(x) if isinstance(x, tuple) else x for x in t]
        while e and e[-1] is None:
            e.pop()
        out[pre[:-1]] = e
    walk(tree, "")
    return out


@contextlib.contextmanager
def _route_margins(got: list):
    """Record, per MoE router call, the smallest gap between a token's
    k-th and (k+1)-th router probabilities: the margin a reordered sum
    would have to cross to flip an expert."""
    from repro_torch.models import moe
    route = moe.route

    def recording(p, cfg, flat):
        k = cfg.moe.top_k
        if k < cfg.moe.num_experts:
            probs = torch.softmax(flat.detach().to(torch.float32)
                                  @ p["router"]["w"].detach(), dim=-1)
            top = torch.topk(probs, k + 1, dim=-1).values
            got.append(float((top[:, k - 1] - top[:, k]).min()))
        return route(p, cfg, flat)

    moe.route = recording
    try:
        yield
    finally:
        moe.route = route


def port_cases(mesh, flat, archs, shapes, only, train_kw, index) -> dict:
    """Every (arch, case) step of the port on this rank's block, gathered
    whole (``sharding.rules.gather_params``); each arch's smallest
    top-k margin under ``margins``."""
    from repro_torch.utils.tree import tree_map
    out = {"margins": {}}
    for arch in archs:
        cfg = _cfg(arch)
        one = tree_map(torch.from_numpy, _unflatten(flat, f"{arch}/init"))
        margins = []
        with _route_margins(margins):
            out.update(_arch_cases(mesh, flat, arch, cfg, one, shapes,
                                   only, archs, train_kw, index))
        if margins:
            out["margins"][arch] = min(margins)
    return out


def _arch_cases(mesh, flat, arch, cfg, one, shapes, only, archs, train_kw,
                index) -> dict:
    """One arch's cases (``port_cases``)."""
    from repro_torch.configs.base import ShapeConfig, TrainConfig
    from repro_torch.launch import steps
    from repro_torch.models.registry import build_model
    from repro_torch.sharding.rules import gather_params
    from repro_torch.utils.tree import tree_map
    out = {}
    for kind, sh in shapes.items():
        if arch not in only.get(kind, archs):
            continue
        pre = f"{arch}/{kind}"
        tcfg = TrainConfig(**train_kw.get(arch, {"remat": False}),
                           shared_server=kind == "shared_server")
        b = steps.build_step(cfg, ShapeConfig(*sh), mesh, train_mode=(
            "shared_server" if kind == "shared_server"
            else "paper_faithful"), tcfg=tcfg)
        if kind == "shared_server":
            from repro_torch.core.phsfl import build_optimizer
            from repro_torch.core.split import part_masks, split_spec_for
            model = build_model(cfg)
            client = part_masks(one, split_spec_for(cfg))["client"]
            stacked = tree_map(lambda c, x: torch.stack([x, x]) if c
                               else x, client, one)
            opt, _ = build_optimizer(model, tcfg, params=stacked)
            whole = (stacked, opt.init(stacked),
                     _unflatten(flat, f"{pre}/in/batch"))
            p, s, m = b.fn(*steps.rank_args(b, whole, mesh))
            out[pre] = {"params": _flat(gather_params(p, b.specs[0],
                                                      mesh)),
                        "state": _flat(gather_params(s, b.specs[1],
                                                     mesh)),
                        "loss": float(m["loss"]),
                        "specs": {"params": _spec_lists(b.specs[0]),
                                  "batch": _spec_lists(b.specs[2])}}
        elif kind == "train":
            from repro_torch.core.phsfl import (build_optimizer,
                                                stack_replicas)
            model = build_model(cfg)
            opt, _ = build_optimizer(model, tcfg, params=one)
            whole = (stack_replicas(one, 2),
                     stack_replicas(opt.init(one), 2),
                     _unflatten(flat, f"{pre}/in/batch"),
                     np.asarray([0.5, 0.5], np.float32),
                     np.asarray([0.5, 0.5], np.float32))
            p, s, m = b.fn(*steps.rank_args(b, whole, mesh))
            out[pre] = {"params": _flat(gather_params(p, b.specs[0],
                                                      mesh)),
                        "state": _flat(gather_params(s, b.specs[1],
                                                     mesh)),
                        "loss": float(m["loss"])}
        elif kind == "prefill":
            whole = (one, _unflatten(flat, f"{pre}/in/batch"))
            lg = b.fn(*steps.rank_args(b, whole, mesh))
            out[pre] = {"logits": gather_params(
                {"x": lg}, {"x": ("data", None, "model")},
                mesh)["x"].numpy()}
        else:
            tok = _unflatten(flat, f"{pre}/in/token")["t"]
            cache = _unflatten(flat, f"{pre}/in/cache")
            cache = _cache_tree(cache, b.args[2])
            whole = (one, tok, cache, index[kind])
            if len(b.args) > 4:
                whole += (_unflatten(flat, f"{pre}/in/positions3")["t"],)
            lg, c = b.fn(*steps.rank_args(b, whole, mesh))
            lead = b.specs[1][0]
            out[pre] = {"logits": gather_params(
                {"x": lg}, {"x": (lead, None, "model")}, mesh)["x"].numpy(),
                "cache": _flat(gather_params(c, b.specs[2], mesh))}
    return out


def _cache_tree(flat_cache, metas):
    """The reference's cache leaves (a recurrent carry's tuple flattened
    to "0", "1", ... keys) as the port's tree, in the metas' dtypes."""
    if isinstance(metas, tuple):
        return tuple(_cache_tree(flat_cache[str(i)], m)
                     for i, m in enumerate(metas))
    if isinstance(metas, dict):
        return {k: _cache_tree(flat_cache[k], m) for k, m in metas.items()}
    return torch.from_numpy(np.asarray(flat_cache)).to(metas.dtype)


def _rank(rank, world, dev, ref_path):
    """One rank of the (data 2, model 2) mesh: every case's step on its
    block, gathered whole on every rank (rank 0's are returned)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.registry import build_model
    from repro_torch.sharding.rules import (gather_params, params_specs,
                                            shard_params)
    from repro_torch.utils.tree import tree_map
    with np.load(ref_path) as z:
        flat = dict(z)
    mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu")
    out = port_cases(mesh, flat, ARCHS, SHAPES, ONLY, TRAIN_KW, INDEX)
    # the rules' block and its inverse, bit for bit
    cfg = _cfg("qwen2-vl-7b")
    one = tree_map(torch.from_numpy, _unflatten(flat, "qwen2-vl-7b/init"))
    for mode in ("tp", "fsdp_tp"):
        spec = params_specs(one, build_model(cfg).axes(), mesh, mode=mode)
        back = gather_params(shard_params(one, spec, mesh), spec, mesh)
        out[f"roundtrip_{mode}"] = all(
            torch.equal(a, b) for a, b in zip(_leaves(back), _leaves(one)))
    # a family beyond the dense decoders at model 2: every step kind
    # builds, and its params' block and inverse are bit for bit
    from repro_torch.utils.prng import make_generator
    olmoe = _cfg("olmoe-1b-7b")
    model = build_model(olmoe)
    built = {}
    for kind in ("train", "prefill", "decode", "shared_server"):
        b = steps.build_step(olmoe, ShapeConfig(*SHAPES[kind]), mesh,
                             train_mode=("shared_server"
                                         if kind == "shared_server"
                                         else "paper_faithful"))
        built[kind] = b.kind
    one = model.init(make_generator(0, "cpu"))
    for mode in ("tp", "fsdp_tp"):
        spec = params_specs(one, model.axes(), mesh, mode=mode)
        back = gather_params(shard_params(one, spec, mesh), spec, mesh)
        built[f"roundtrip_{mode}"] = all(
            torch.equal(a, b) for a, b in zip(_leaves(back), _leaves(one)))
    out["olmoe_built"] = built
    return out if rank == 0 else {"olmoe_built": built}


def _leaves(tree):
    from repro_torch.utils.tree import tree_leaves
    return tree_leaves(tree)


def run_cases(tmp_path_factory, rank_fn, name, archs, shapes, index,
              train_kw, only):
    """The reference's cases in one subprocess on four fake CPU devices,
    then ``rank_fn(rank, world, dev, ref_path)`` on four gloo ranks (one
    intra-op thread each): (the reference's flat outputs, the ranks'
    results)."""
    from repro_torch.launch.distributed import spawn
    path = tmp_path_factory.mktemp(name) / "reference.npz"
    run = subprocess.run(
        [sys.executable, "-c", _REFERENCE, str(path),
         json.dumps([archs, shapes, index, train_kw, only])],
        capture_output=True, text=True, timeout=900, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
             "JAX_PLATFORMS": "cpu"})
    assert run.returncode == 0, run.stderr[-3000:]
    with np.load(path) as z:
        ref = dict(z)
    ranks = spawn(rank_fn, 4, (str(path),), device="cpu", threads=1,
                  timeout=900)
    return ref, ranks


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_cases(tmp_path_factory, _rank, "steps_tp", ARCHS, SHAPES,
                     INDEX, TRAIN_KW, ONLY)


def _close(got, want, what, tol=TOL):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (what, err, scale)


def _cases(kind):
    return [a for a in ARCHS if a in ONLY.get(kind, ARCHS)]


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits(runs, arch):
    ref, ranks = runs
    got = ranks[0][f"{arch}/prefill"]["logits"]
    _close(got, ref[f"{arch}/prefill/out/logits"], arch)


@pytest.mark.parametrize("kind,arch", [(k, a) for k in ("decode",
                                                       "decode_b1")
                                       for a in _cases(k)])
def test_decode_logits_and_cache(runs, kind, arch):
    ref, ranks = runs
    check_decode(ref, ranks[0][f"{arch}/{kind}"], arch, kind)


def check_decode(ref, row, arch, kind):
    """The logits, and every cache slot: an attention cache (bf16) holds
    every slot but this token's as it was (exactly), and this token's k
    and v are float32 sums of a different order rounded to bf16 (one
    rounding step apart); a recurrent state (float32) within TOL."""
    _close(row["logits"], ref[f"{arch}/{kind}/out/logits"], (arch, kind))
    want = {k[len(f"{arch}/{kind}/out/cache/"):]: v for k, v in ref.items()
            if k.startswith(f"{arch}/{kind}/out/cache/")}
    assert set(row["cache"]) == set(want)
    for k, v in want.items():
        got, leaf = row["cache"][k], k.rsplit("/", 1)[-1]
        if leaf in ("k", "v", "c_kv", "k_rope"):
            length = -3 if leaf in ("k", "v") else -2
            differ = np.argwhere(got != v)
            assert len(np.unique(differ[:, length])) <= 1, (arch, kind, k)
            _close(got, v, (arch, kind, k), BF16_TOL)
        else:
            _close(got, v, (arch, kind, k))


def _check_train(ref, row, arch, kind, writes=1, zero_grad=()):
    """The params, optimizer state and loss after the step, and each
    leaf's update (after - before) against the reference's: within TOL of
    the update's largest magnitude, plus ``writes`` units in the last
    place of the leaf's largest value (the rounding of the stored params,
    which the update's own scale does not bound: the chip's ``tp_gemma``
    counts one a write of the weights, a round's local steps and its edge
    average).  Leaves named in ``zero_grad`` have a gradient of exactly 0
    in exact arithmetic, so both sides' updates are rounding noise: each
    is held under TOL of the median leaf's update instead."""
    init = {k[len(f"{arch}/init/"):]: v for k, v in ref.items()
            if k.startswith(f"{arch}/init/")}
    for part in ("params", "state"):
        pre = f"{arch}/{kind}/out/{part}/"
        want = {k[len(pre):]: v for k, v in ref.items() if k.startswith(pre)}
        assert set(row[part]) == set(want), part
        for k, v in want.items():
            _close(row[part][k], v, (arch, kind, part, k))
    margins, scales, noise = [], [], {}
    for k, v in init.items():
        after = ref[f"{arch}/{kind}/out/params/{k}"]
        want = after - v
        got = row["params"][k] - v
        scale = float(np.abs(want).max())
        if k.endswith(zero_grad) and zero_grad:
            noise[k] = max(scale, float(np.abs(got).max()))
            continue
        scales.append(scale)
        ulp = writes * float(np.spacing(np.abs(after).max()))
        err = float(np.abs(got - want).max())
        assert err <= TOL * scale + ulp, (arch, kind, k, err, scale, ulp)
        margins.append(scale / (TOL * scale + ulp))
    # the update stands far above the limit on most leaves
    assert np.median(margins) > 100, sorted(margins)
    for k, n in noise.items():
        assert n <= TOL * float(np.median(scales)), (arch, kind, k, n)
    want = float(ref[f"{arch}/{kind}/out/loss"])
    assert abs(row["loss"] - want) <= TOL * max(1.0, abs(want))


@pytest.mark.parametrize("arch", ARCHS)
def test_train_round(runs, arch):
    ref, ranks = runs
    _check_train(ref, ranks[0][f"{arch}/train"], arch, "train")


@pytest.mark.parametrize("arch", _cases("shared_server"))
def test_shared_server_step(runs, arch):
    ref, ranks = runs
    _check_train(ref, ranks[0][f"{arch}/shared_server"], arch,
                 "shared_server")


def test_shard_and_gather_are_inverse(runs):
    _, ranks = runs
    assert ranks[0]["roundtrip_tp"] and ranks[0]["roundtrip_fsdp_tp"]


def test_a_non_dense_arch_at_model_two_builds(runs):
    """olmoe-1b-7b (the MoE) at model 2: every step kind builds, and the
    rules' block of its params and the gather back are the identity."""
    _, ranks = runs
    for r in ranks:
        built = r["olmoe_built"]
        assert {k: built[k] for k in ("train", "prefill", "decode",
                                      "shared_server")} == {
            "train": "train", "prefill": "prefill", "decode": "decode",
            "shared_server": "train"}
        assert built["roundtrip_tp"] and built["roundtrip_fsdp_tp"]


def check_shared_server_specs(ref, row, arch):
    """The shared-server bundle's params and batch specs are the
    reference's, leaf for leaf (its ``fsdp_tp`` body, its client block
    over the client dims only)."""
    def bare(spec):
        spec = list(spec)
        while spec and spec[-1] is None:
            spec.pop()
        return spec

    for part in ("params", "batch"):
        want = json.loads(str(ref[f"{arch}/shared_server/specs/{part}"]))
        assert row["specs"][part] == {k: bare(v) for k, v in want.items()}, \
            part


@pytest.mark.parametrize("arch", _cases("shared_server"))
def test_shared_server_specs_match_the_reference(runs, arch):
    ref, ranks = runs
    check_shared_server_specs(ref, ranks[0][f"{arch}/shared_server"], arch)
