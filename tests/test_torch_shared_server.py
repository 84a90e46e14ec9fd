"""Port parity for the shared-server step (``repro_torch.core.phsfl.
make_shared_server_step``, ``init_shared_server_params``) against the
reference's, on reduced mistral-large-123b and reduced olmoe-1b-7b (the
MoE, which the reference maps over clients with ``lax.map``): four
clients, one step of micro-batch 2 x 32 tokens, then both
``sync_clients`` (each pod's mean, and the mean over all clients).

The reference's step is jitted on a (1, 1) mesh from its own initial
parameters.  Its ``sync_clients`` reads the mesh's pod count only, so the
per-pod mean of a two-pod mesh comes from a stand-in with that shape.
The port runs the same step at world size 1 (all four clients on one
rank; a one-rank gloo group in this process) and on four gloo ranks of a
(2, 2, 1) mesh, one client each (``launch.distributed.spawn``).

Tolerance: rtol 2e-5 / atol 2e-6, the host round's
(``tests/test_host_round.py:78-79``), on parameters, optimizer states and
the loss; the frozen head exactly.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from test_torch_mesh_round import _flat, _unflatten

C, MICRO, SEQ = 4, 2, 32
TOL = dict(rtol=2e-5, atol=2e-6)
ARCHS = ["mistral-large-123b", "olmoe-1b-7b"]


def _configs(arch):
    from repro_torch.configs.base import HierarchyConfig, TrainConfig
    from repro_torch.configs.registry import get_arch
    return (get_arch(arch).reduced(),
            HierarchyConfig(num_edge_servers=2, clients_per_es=2),
            TrainConfig(learning_rate=0.05, freeze_head=True, remat=False))


def _run_port(arch, flat, mesh):
    """The port's step and both syncs on this rank's clients."""
    from repro_torch.core.phsfl import make_shared_server_step
    from repro_torch.models.registry import build_model
    from repro_torch.utils.tree import tree_map
    cfg, hcfg, tcfg = _configs(arch)
    model = build_model(cfg)
    step = make_shared_server_step(model, hcfg, tcfg, mesh, num_clients=C)
    mine = step.clients
    params = _unflatten(flat, "init/params")
    params = tree_map(lambda m, x: x[mine.start:mine.stop] if m else x,
                      step.client_mask, params)
    state = _unflatten(flat, "init/state")
    batch = {k: torch.from_numpy(np.array(
        flat[f"batch/{k}"][mine.start:mine.stop])) for k in ("tokens",
                                                             "labels")}
    p, s, m = step.fn(params, state, batch)
    return {"clients": (mine.start, mine.stop), "params": _flat(p),
            "state": _flat(s), "loss": float(m["loss"]),
            "pod": _flat(step.sync_clients(p, False)),
            "all": _flat(step.sync_clients(p, True)),
            "client_mask": step.client_mask}


def _rank_worker(rank, world, dev, arch, path):
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh((2, 2, 1), ("pod", "data", "model"), device_type="cpu")
    with np.load(path) as z:
        return _run_port(arch, dict(z), mesh)


@pytest.fixture(scope="module", params=ARCHS)
def reference(request, tmp_path_factory):
    """The reference's step and syncs, with its inputs, flattened."""
    import jax
    import jax.numpy as jnp
    from repro.configs.base import HierarchyConfig as JH
    from repro.configs.base import TrainConfig as JT
    from repro.configs.registry import get_arch as j_get_arch
    from repro.core import build_optimizer
    from repro.core.phsfl import (init_shared_server_params,
                                  make_shared_server_step)
    from repro.data.synthetic import synthetic_token_batch
    from repro.launch.mesh import set_mesh
    from repro.models import build_model as j_build
    from repro.utils.tree import map_with_path
    arch = request.param
    jm = j_build(j_get_arch(arch).reduced())
    jt = JT(learning_rate=0.05, freeze_head=True, remat=False)
    jh = JH(num_edge_servers=2, clients_per_es=2)
    params = init_shared_server_params(jm, jax.random.PRNGKey(0), C)
    opt, _ = build_optimizer(jm, jt)
    state = opt.init(params)
    nb = synthetic_token_batch(0, C * MICRO, SEQ, jm.cfg.vocab_size)
    batch = {k: jnp.asarray(v).reshape(C, MICRO, SEQ)
             for k, v in nb.items()}
    out = {}

    def put(prefix, tree):
        map_with_path(lambda p, x: out.__setitem__(f"{prefix}/{p}",
                                                   np.asarray(x)), tree)

    put("init/params", params)
    put("init/state", state)
    out["batch/tokens"] = np.asarray(batch["tokens"])
    out["batch/labels"] = np.asarray(batch["labels"])
    # Auto axes: under jax 0.9's default Explicit ones the MoE's jnp.repeat
    # asks for an out_sharding (the reference's code predates them)
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    with set_mesh(mesh):
        step = make_shared_server_step(jm, jh, jt, mesh, C)
        p, s, m = jax.jit(step.fn)(params, state, batch)
    put("step/params", p)
    put("step/state", s)
    out["step/loss"] = np.asarray(m["loss"])
    two_pods = SimpleNamespace(shape={"pod": 2, "data": 2, "model": 1})
    put("pod/params", make_shared_server_step(jm, jh, jt, two_pods, C)
        .sync_clients(p, False))
    put("all/params", step.sync_clients(p, True))
    path = tmp_path_factory.mktemp("shared") / f"{arch}.npz"
    np.savez(path, **out)
    return arch, path, out


@pytest.fixture(scope="module")
def one_rank(reference):
    """World size 1: a one-rank gloo group in this process."""
    import torch.distributed as dist
    from repro_torch.launch.distributed import free_port
    from repro_torch.launch.mesh import make_mesh
    arch, _, ref = reference
    dist.init_process_group("gloo", init_method=f"tcp://localhost:"
                            f"{free_port()}", rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), device_type="cpu")
        return _run_port(arch, ref, mesh)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def four_ranks(reference):
    from repro_torch.launch.distributed import spawn
    arch, path, _ = reference
    return spawn(_rank_worker, 4, (arch, str(path)), threads=2, timeout=300)


def _check(got, ref, name, lo, hi, client_mask_paths):
    """``got[name]``'s leaves against the reference's ``name`` leaves;
    client leaves sliced to clients [lo, hi)."""
    want = {k[len(name) + 1:]: v for k, v in ref.items()
            if k.startswith(name + "/")}
    assert got.keys() == want.keys()
    for k, w in want.items():
        if k in client_mask_paths:
            w = w[lo:hi]
        assert got[k].shape == w.shape and got[k].dtype == w.dtype, k
        np.testing.assert_allclose(got[k], w, **TOL, err_msg=f"{name} {k}")


def _client_paths(res):
    from repro_torch.utils.tree import path_leaves
    return {p for p, m in path_leaves(res["client_mask"]) if m}


def _compare(res, ref, pods=2):
    """One pod (world size 1): each pod's mean is the mean over all."""
    lo, hi = res["clients"]
    cp = _client_paths(res)
    assert cp and all(p.startswith(("embed", "stage0")) for p in cp)
    _check(res["params"], ref, "step/params", lo, hi, cp)
    _check(res["state"], ref, "step/state", lo, hi, cp)
    np.testing.assert_allclose(res["loss"], float(ref["step/loss"]), **TOL)
    _check(res["pod"], ref, "pod/params" if pods == 2 else "all/params", lo,
           hi, cp)
    _check(res["all"], ref, "all/params", lo, hi, cp)
    head = "lm_head/w"
    assert np.array_equal(res["params"][head], ref[f"init/params/{head}"])


def test_shared_server_step_at_world_size_one(reference, one_rank):
    _, _, ref = reference
    assert one_rank["clients"] == (0, C)
    _compare(one_rank, ref, pods=1)


def test_shared_server_step_on_four_ranks(reference, four_ranks):
    _, _, ref = reference
    assert [r["clients"] for r in four_ranks] == [(c, c + 1)
                                                   for c in range(C)]
    for r in four_ranks:
        _compare(r, ref)
    # the shared leaves agree on every rank after the summed gradients
    shared = [k for k in four_ranks[0]["params"]
              if k not in _client_paths(four_ranks[0])]
    for r in four_ranks[1:]:
        for k in shared:
            assert np.array_equal(r["params"][k], four_ranks[0]["params"][k])


def test_init_shared_server_params_stacks_the_client_block():
    from repro_torch.core.phsfl import (abstract_params,
                                        init_shared_server_params)
    from repro_torch.models.registry import build_model
    from repro_torch.utils.prng import make_generator
    from repro_torch.utils.tree import path_leaves
    cfg, _, _ = _configs("mistral-large-123b")
    model = build_model(cfg)
    p = init_shared_server_params(model, make_generator(0), 3)
    one = dict(path_leaves(abstract_params(model)))
    for path, x in path_leaves(p):
        if path.startswith(("embed", "stage0")):
            assert x.shape == (3, *one[path].shape), path
            assert torch.equal(x[0], x[2])
        else:
            assert x.shape == one[path].shape, path
