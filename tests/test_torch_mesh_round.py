"""Port parity for the mesh round (``repro_torch.core.phsfl.
make_phsfl_round`` and ``core.hierarchy``'s mesh half) against the
reference's ``make_phsfl_round`` on a (2, 2, 1) ("pod", "data", "model")
mesh: two ESs of two clients, reduced mistral-large-123b, kappa0 = 2
local steps of micro-batch 2 x 32 tokens, uneven alpha_u and alpha_b.

- The reference runs in a subprocess on four fake CPU devices
  (``XLA_FLAGS=--xla_force_host_platform_device_count=4``): the unmasked
  round with global sync, then its participation round under a partial
  mask (ES 0 loses a client) and under one that empties ES 0.  It reads
  its sharded outputs through ``np.asarray``: host-side indexing of them
  raises on jax 0.9 (R6 in ROADMAP.md).
- The port runs the same three rounds on four gloo ranks on the CPU
  (``repro_torch.launch.distributed.spawn``, two threads a rank), each
  rank one client, from the reference's initial parameters; rank 0 also
  runs the port's host round on all four clients.

Tolerance: the host round's, rtol 2e-5 / atol 2e-6
(``tests/test_host_round.py:78-79``) on parameters, optimizer states and
the loss; exact for the frozen head.  The mesh round equals the port's
host round bit for bit (each sum adds two operands, in any order the
same), and its params spec is the reference's.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
C, K, MICRO, SEQ = 4, 2, 2, 32
TOL = dict(rtol=2e-5, atol=2e-6)
ALPHA_U = [0.25, 0.75, 0.5, 0.5]
ALPHA_B = [0.3, 0.3, 0.7, 0.7]
MASKS = {"partial": [1.0, 0.0, 1.0, 1.0], "empty_es": [0.0, 0.0, 1.0, 0.0]}

_REFERENCE = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.configs.registry import get_arch
from repro.configs.base import HierarchyConfig, TrainConfig
from repro.models import build_model
from repro.core import make_phsfl_round, init_stacked_params, build_optimizer
from repro.data.synthetic import synthetic_token_batch
from repro.launch.mesh import set_mesh
from repro.utils.tree import map_with_path
C, K, MICRO, SEQ = 4, 2, 2, 32
ALPHA_U, ALPHA_B, MASKS = json.loads(sys.argv[2])
mesh = jax.make_mesh((2, 2, 1), ("pod", "data", "model"))
cfg = get_arch("mistral-large-123b").reduced()
model = build_model(cfg)
h = HierarchyConfig(num_edge_servers=2, clients_per_es=2, kappa0=K, kappa1=1)
t = TrainConfig(learning_rate=0.05, freeze_head=True, local_steps_in_step=K,
                remat=False)
params = init_stacked_params(model, jax.random.PRNGKey(0), C)
opt, _ = build_optimizer(model, t)
s1 = opt.init(jax.tree.map(lambda x: x[0], params))
state = jax.tree.map(lambda x: jnp.broadcast_to(x[None], (C,) + x.shape), s1)
nb = synthetic_token_batch(0, C * K * MICRO, SEQ, cfg.vocab_size)
batch = {k: jnp.asarray(v).reshape(C, K, MICRO, SEQ) for k, v in nb.items()}
au = jnp.asarray(ALPHA_U, jnp.float32)
ab = jnp.asarray(ALPHA_B, jnp.float32)
out = {}
def put(prefix, tree):
    # np.asarray, not x[0]: indexing a sharded output raises on jax 0.9 (R6)
    map_with_path(lambda p, x: out.__setitem__(f"{prefix}/{p}",
                                               np.asarray(x)), tree)
put("init/params", params)
put("init/state", state)
out["batch/tokens"] = np.asarray(batch["tokens"])
out["batch/labels"] = np.asarray(batch["labels"])
with set_mesh(mesh):
    rnd = make_phsfl_round(model, h, t, mesh, global_sync=True)
    p, s, m = jax.jit(rnd.fn)(params, state, batch, au, ab)
    put("plain/params", p)
    put("plain/state", s)
    out["plain/loss"] = np.asarray(m["loss"])
    specs = {}
    flat = jax.tree_util.tree_flatten_with_path(
        rnd.params_spec, is_leaf=lambda x: isinstance(x, P))[0]
    for path, sp in flat:
        specs["/".join(str(k.key) for k in path)] = [
            list(e) if isinstance(e, tuple) else e for e in sp]
    out["spec"] = np.asarray(json.dumps(specs))
    masked = jax.jit(make_phsfl_round(model, h, t, mesh, global_sync=True,
                                      participation=True).fn)
    for name, mask in MASKS.items():
        p, s, m = masked(params, state, batch, au, ab,
                         jnp.asarray(mask, jnp.float32))
        put(f"{name}/params", p)
        put(f"{name}/state", s)
        out[f"{name}/loss"] = np.asarray(m["loss"])
np.savez(sys.argv[1], **out)
"""


def _unflatten(flat: dict, prefix: str) -> dict:
    """{"prefix/a/b": array} -> {"a": {"b": tensor}}."""
    tree = {}
    for key, a in flat.items():
        if not key.startswith(prefix + "/"):
            continue
        *dirs, leaf = key[len(prefix) + 1:].split("/")
        node = tree
        for d in dirs:
            node = node.setdefault(d, {})
        node[leaf] = torch.from_numpy(np.array(a))
    return tree


def _flat(tree) -> dict:
    from repro_torch.utils.tree import path_leaves
    return {p: t.detach().cpu().numpy() for p, t in path_leaves(tree)}


def _configs():
    from repro_torch.configs.base import HierarchyConfig, TrainConfig
    from repro_torch.configs.registry import get_arch
    cfg = get_arch("mistral-large-123b").reduced()
    hcfg = HierarchyConfig(num_edge_servers=2, clients_per_es=2, kappa0=K,
                           kappa1=1)
    tcfg = TrainConfig(learning_rate=0.05, freeze_head=True,
                       local_steps_in_step=K, remat=False)
    return cfg, hcfg, tcfg


def _mesh_worker(rank, world, dev, ref_path):
    """One client rank: the three mesh rounds and reduced olmoe's round
    at model 2; rank 0 adds the host rounds on all four clients."""
    from repro_torch.core.phsfl import (client_index, make_host_round,
                                        make_phsfl_round)
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.registry import build_model
    from repro_torch.utils.tree import tree_map
    cfg, hcfg, tcfg = _configs()
    model = build_model(cfg)
    with np.load(ref_path) as z:
        flat = dict(z)
    params, state = _unflatten(flat, "init/params"), _unflatten(
        flat, "init/state")
    batch = {k: torch.from_numpy(flat[f"batch/{k}"]) for k in ("tokens",
                                                             "labels")}
    au, ab = torch.tensor(ALPHA_U), torch.tensor(ALPHA_B)
    mesh = make_mesh((2, 2, 1), ("pod", "data", "model"), device_type="cpu")
    c = client_index(mesh)
    mine = lambda t: t[c:c + 1]
    out = {"client": c}
    plain = make_phsfl_round(model, hcfg, tcfg, mesh, global_sync=True)
    masked = make_phsfl_round(model, hcfg, tcfg, mesh, global_sync=True,
                              participation=True)
    args = (tree_map(mine, params), tree_map(mine, state),
            {k: mine(v) for k, v in batch.items()}, mine(au), mine(ab))
    p, s, m = plain.fn(*args)
    out["plain"] = (_flat(p), _flat(s), float(m["loss"]))
    out["spec"] = plain.params_spec
    for name, mask in MASKS.items():
        p, s, m = masked.fn(*args, mine(torch.tensor(mask)))
        out[name] = (_flat(p), _flat(s), float(m["loss"]))
    if rank == 0:
        host = {}
        hplain = make_host_round(model, hcfg, tcfg, num_clients=C,
                                 global_sync=True)
        p, s, m = hplain.fn(params, state, batch, au, ab)
        host["plain"] = (_flat(p), _flat(s), float(m["loss"]))
        hmasked = make_host_round(model, hcfg, tcfg, num_clients=C,
                                  global_sync=True, participation=True)
        for name, mask in MASKS.items():
            p, s, m = hmasked.fn(params, state, batch, au, ab,
                                 torch.tensor(mask))
            host[name] = (_flat(p), _flat(s), float(m["loss"]))
        out["host"] = host
    # a mesh is a collective: every rank builds the tensor-parallel one,
    # then runs reduced olmoe-1b-7b's round on it (its experts, heads and
    # vocabulary split over "model"), two clients on the "data" dim
    out["olmoe_tp"] = _olmoe_tp_round(rank, flat)
    return out


def _olmoe_tp_round(rank, flat):
    """Reduced olmoe-1b-7b's round on a (data 2, model 2) mesh, gathered
    whole, and on rank 0 the host round of the same two clients."""
    from repro_torch.configs.base import HierarchyConfig
    from repro_torch.configs.registry import get_arch
    from repro_torch.core.phsfl import (build_optimizer, make_host_round,
                                        make_phsfl_round, stack_replicas)
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import _state_specs
    from repro_torch.models.registry import build_model
    from repro_torch.sharding.rules import gather_params, shard_params
    from repro_torch.utils.prng import make_generator
    _, _, tcfg = _configs()
    hcfg = HierarchyConfig(num_edge_servers=1, clients_per_es=2, kappa0=K,
                           kappa1=1)
    model = build_model(get_arch("olmoe-1b-7b").reduced())
    one = model.init(make_generator(0, "cpu"))
    opt, _ = build_optimizer(model, tcfg, params=one)
    params, state = stack_replicas(one, 2), stack_replicas(opt.init(one), 2)
    batch = {k: torch.from_numpy(flat[f"batch/{k}"][:2]) for k in (
        "tokens", "labels")}
    au = torch.tensor([0.25, 0.75])
    tp = make_mesh((2, 2), ("data", "model"), device_type="cpu")
    rnd = make_phsfl_round(model, hcfg, tcfg, tp, global_sync=False)
    spec = rnd.params_spec
    c = tp.get_local_rank("data")
    mine = lambda t: t[c:c + 1]  # noqa: E731
    p, s, m = rnd.fn(shard_params(params, spec, tp),
                     shard_params(state, _state_specs(state, spec,
                                                      ("data",)), tp),
                     {k: mine(v) for k, v in batch.items()}, mine(au),
                     mine(au))
    got = (_flat(gather_params(p, spec, tp)), float(m["loss"]))
    if rank:
        return {"tp": got}
    host = make_host_round(model, hcfg, tcfg, num_clients=2,
                           global_sync=False)
    p, s, m = host.fn(params, state, batch, au, au)
    return {"tp": got, "host": (_flat(p), float(m["loss"])),
            "init": _flat(params)}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("mesh") / "reference.npz"
    run = subprocess.run(
        [sys.executable, "-c", _REFERENCE, str(path),
         json.dumps([ALPHA_U, ALPHA_B, MASKS])],
        capture_output=True, text=True, timeout=600, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
             "JAX_PLATFORMS": "cpu"})
    assert run.returncode == 0, run.stderr[-3000:]
    with np.load(path) as z:
        return path, dict(z)


@pytest.fixture(scope="module")
def ranks(reference):
    from repro_torch.launch.distributed import spawn
    return spawn(_mesh_worker, 4, (str(reference[0]),), threads=2,
                 timeout=300)


def _ref_client(ref, case, part, c):
    prefix = f"{case}/{part}/"
    return {k[len(prefix):]: v[c] for k, v in ref.items()
            if k.startswith(prefix)}


def test_ranks_hold_one_client_each_pod_major(ranks):
    assert [r["client"] for r in ranks] == [0, 1, 2, 3]


@pytest.mark.parametrize("case", ["plain", *MASKS])
def test_mesh_round_matches_reference(reference, ranks, case):
    _, ref = reference
    for r in ranks:
        c = r["client"]
        p, s, loss = r[case]
        for part, got in (("params", p), ("state", s)):
            want = _ref_client(ref, case, part, c)
            assert got.keys() == want.keys()
            for k in want:
                assert got[k].shape == (1, *want[k].shape), k
                assert got[k].dtype == want[k].dtype, k
                np.testing.assert_allclose(got[k][0], want[k], **TOL,
                                           err_msg=f"{case} {part} {k}")
        np.testing.assert_allclose(loss, float(ref[f"{case}/loss"]), **TOL)
        assert np.isfinite(loss)
        # the frozen head takes no step: it moves only by the rounding of
        # the uneven weighted sums, exactly as the reference's does
        head = "lm_head/w"
        assert np.array_equal(p[head][0], ref[f"{case}/params/{head}"][c])


@pytest.mark.parametrize("case", ["plain", *MASKS])
def test_mesh_round_equals_host_round_bit_for_bit(ranks, case):
    host = ranks[0]["host"][case]
    for r in ranks:
        c = r["client"]
        for got, want in zip(r[case][:2], host[:2]):
            assert got.keys() == want.keys()
            for k in want:
                assert np.array_equal(got[k][0], want[k][c]), (case, k, c)
        np.testing.assert_allclose(r[case][2], host[2], rtol=1e-6)


def test_masked_rounds_keep_the_reference_semantics(reference, ranks):
    """Under global sync every client ends equal; when ES 0 is emptied
    it keeps no model of its own: the global step over ES 1 alone
    reaches every client."""
    _, ref = reference
    for case in ("plain", *MASKS):
        first = ranks[0][case][0]
        for r in ranks[1:]:
            for k in first:
                assert np.array_equal(r[case][0][k], first[k]), (case, k)
    body = "final_norm/scale"
    assert not np.array_equal(ranks[0]["empty_es"][0][body][0],
                              ref[f"init/params/{body}"][0])


def test_params_spec_matches_reference(reference, ranks):
    _, ref = reference
    want = json.loads(str(ref["spec"]))

    def flat(tree, prefix=""):
        if isinstance(tree, dict):
            out = {}
            for k, v in tree.items():
                out.update(flat(v, f"{prefix}{k}/"))
            return out
        return {prefix[:-1]: [list(e) if isinstance(e, tuple) else e
                              for e in tree]}

    assert flat(ranks[0]["spec"]) == want


def test_a_model_dim_above_one_runs_the_moe(ranks):
    """Reduced olmoe-1b-7b's round at (data 2, model 2) equals the host
    round of the same two clients within the file's tolerance, and its
    update is not lost: a gradient that missed its sum over "model"
    moves the weights by half their step (~1e-4 at lr 0.05, far above
    atol)."""
    row = ranks[0]["olmoe_tp"]
    (got, loss), (want, host_loss) = row["tp"], row["host"]
    assert got.keys() == want.keys()
    moved = 0
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **TOL, err_msg=k)
        moved += not np.array_equal(want[k], row["init"][k])
    assert moved > len(want) // 2
    np.testing.assert_allclose(loss, host_loss, **TOL)
    assert np.isfinite(loss)
    for r in ranks[1:]:
        for k in got:
            assert np.array_equal(r["olmoe_tp"]["tp"][0][k], got[k]), k
