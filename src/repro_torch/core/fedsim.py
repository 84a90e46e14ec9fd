"""Faithful PHSFL simulation (paper Secs. III–V) on the paper's CNN.

The PyTorch rendering of ``repro.core.fedsim`` on its ideal-network path:

- B edge servers, U_b clients each, Dirichlet(alpha) non-IID data;
- the literal split exchange (Steps 3.2–3.8, ``split_grad``), with the
  cut-layer codecs applied on the wire;
- PHSFL: the head (fc2) is frozen during global training (Eq. 12);
  HSFL baseline: identical but the head trains;
- weighted edge aggregation every kappa0 local epochs (Eqs. 14-15) and
  global aggregation every kappa1 edge rounds (Eq. 16);
- personalization: K head-only SGD steps per client (Eq. 18).

The reference ``vmap``s the per-client step over stacked parameter
replicas; here the client dimension is written out: every parameter leaf
is (U, ...), a minibatch is (U, N, ...), and one stacked forward and
backward step trains all U clients (``models.cnn`` ``*_stacked``).  The
minibatch stream is the reference's draw for draw (numpy, seeded), and
the dataset stays resident on the device, so a step copies only the
drawn indices to it.

The wireless scheduler, population mode and staleness-weighted
aggregation are the port's wireless slice (ROADMAP.md) and raise here;
saving and restoring on disk wait too (``state_dict``/``load_state_dict``
work in memory).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.checkpoint.rng import restore_rng_state, rng_state_array
from repro_torch.configs.base import HierarchyConfig, TrainConfig
from repro_torch.configs.phsfl_cnn import CNNConfig
from repro_torch.data.synthetic import FederatedImageData
from repro_torch.device import resolve_device
from repro_torch.models import cnn
from repro_torch.utils.prng import (draw_seed, fold_in, fold_in_str,
                                    make_generator)
from repro_torch.utils.tree import (tree_leaves, tree_leaves_with_path,
                                    tree_map)


def _unflatten(tree, leaves):
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def _trainable(tree):
    return tree_map(lambda t: t.detach().requires_grad_(True), tree)


# ---------------------------------------------------------------------------
def split_grad_stacked(params, x, y, cut: str = cnn.DEFAULT_CUT, *,
                       codecs=None, generator=None):
    """The split exchange (Steps 3.2–3.8) of U clients at once.

    ``params`` leaves are (U, ...), ``x`` (U, N, H, W, C), ``y`` (U, N).
    Returns each client's mean loss (U,) and its gradients (a tree like
    ``params``): the reference's ``vmap(split_grad)``.

    ``codecs`` (a ``LinkCodecs``) push the two cut-layer payloads through
    their lossy channel where the wire sits, outside autograd: the ES
    computes its forward and its gradient at the decoded activations, and
    the client backprops from the decoded gradient.  ``generator`` (on
    x's device) drives stochastic codecs; identity or no codecs reproduce
    the uncompressed dataflow bit for bit."""
    if codecs is not None and generator is None and not codecs.is_lossless():
        # a silent fixed stream would reuse the SAME rounding noise every
        # minibatch, correlating the quantization error the stochastic
        # rounding exists to keep unbiased
        raise ValueError("stochastic codecs need an explicit "
                         "generator= per call")
    client_keys = cnn.client_keys_for(cut)
    client_p = _trainable({k: params[k] for k in client_keys})
    server_p = _trainable({k: params[k] for k in params
                           if k not in client_keys})
    with torch.enable_grad():
        # Step 3.2: client forward to the cut layer
        o_fp = cnn.client_forward_stacked(client_p, x, cut)

        # Step 3.4 wire: o_fp crosses the uplink through the activation codec
        o = o_fp.detach()
        if codecs is not None and codecs.activations is not None:
            o = codecs.activations.apply(generator, o)
        o = o.requires_grad_(True)

        # Steps 3.5–3.6: server forward + server-side backprop
        logits = cnn.server_forward_stacked(server_p, o, cut)
        loss = cnn.nll_stacked(logits, y).mean(-1)
        s_leaves = tree_leaves(server_p)
        *g_server, o_bp = torch.autograd.grad(loss.sum(), s_leaves + [o])

        # Step 3.7 wire: o_bp crosses the downlink through the gradient codec
        if codecs is not None and codecs.gradients is not None:
            o_bp = codecs.gradients.apply(generator, o_bp)

        # Step 3.8: cut-layer gradient back to the client; client VJP
        g_client = torch.autograd.grad(o_fp, tree_leaves(client_p),
                                       grad_outputs=o_bp)
    return loss.detach(), {**_unflatten(client_p, g_client),
                           **_unflatten(server_p, g_server)}


def split_grad(params, x, y, cut: str = cnn.DEFAULT_CUT, *, codecs=None,
               generator=None):
    """Literal split-learning gradient exchange (Steps 3.2–3.8) of one
    client at ``cut``: the reference's signature, with a generator where
    it takes a key.  Remark 2 in code: the result does not depend on the
    cut."""
    loss, g = split_grad_stacked(tree_map(lambda t: t[None], params),
                                 x[None], y[None], cut, codecs=codecs,
                                 generator=generator)
    return loss[0], tree_map(lambda t: t[0], g)


def monolithic_grad(params, x, y):
    """Reference: ordinary end-to-end backprop (for the Remark-2 test)."""
    p = _trainable(params)
    with torch.enable_grad():
        loss = cnn.loss_fn(p, x, y)
        g = torch.autograd.grad(loss, tree_leaves(p))
    return loss.detach(), _unflatten(p, g)


# ---------------------------------------------------------------------------
@dataclass
class FedSimResult:
    history: list = field(default_factory=list)          # per-round metrics
    global_params: dict | None = None
    personalized_heads: dict | None = None               # stacked (U, ...)
    per_client_global: dict | None = None                # eval of w*
    per_client_personalized: dict | None = None          # eval of w_u^K
    network: list = field(default_factory=list)          # per-edge-round
    total_sim_time_s: float = 0.0                        # simulated clock


class FedSim:
    """Runs PHSFL (freeze_head=True) or HSFL (False) on federated data.

    ``device=None`` means the card (``repro_torch.device``); pass
    ``device="cpu"`` to run on the CPU."""

    def __init__(self, cfg: CNNConfig, data: FederatedImageData,
                 hcfg: HierarchyConfig, tcfg: TrainConfig, *,
                 batches_per_epoch: int = 5, seed: int = 0,
                 wireless=None, cut: str | None = None, codecs=None,
                 population=None, device=None):
        if population is not None:
            raise NotImplementedError(
                "population mode is part of the port's wireless slice "
                "(ROADMAP.md)")
        if wireless is not None and (
                wireless.model != "ideal"
                or getattr(wireless, "staleness_lambda", 0.0) > 0.0):
            raise NotImplementedError(
                "non-ideal wireless networks and staleness-weighted "
                "aggregation are the port's wireless slice (ROADMAP.md); "
                "this slice runs the ideal network")
        if data.num_clients != hcfg.num_clients:
            raise ValueError(f"data has {data.num_clients} clients, the "
                             f"hierarchy {hcfg.num_clients}")
        self.device = resolve_device(device)
        self.cfg, self.data, self.h, self.t = cfg, data, hcfg, tcfg
        self.batches_per_epoch = batches_per_epoch
        # the TRAINING cut: Remark 2 makes the trajectory invariant to it
        self.cut = cut if cut is not None else cnn.DEFAULT_CUT
        if self.cut not in cnn.CUT_CANDIDATES:
            raise ValueError(f"unknown cut {self.cut!r}")
        # the TRAINING codecs: applied in the literal dataflow (activations
        # and gradients at the cut each minibatch, client-block offload
        # before every edge aggregation)
        self.codecs = codecs
        self.seed = seed
        self.rng = np.random.default_rng(seed)
        # codec seed chain: one seed per codec application, disjoint from
        # the data-sampling stream and the init stream
        self._codec_seeds = (make_generator(fold_in(seed, 0xC0DEC))
                             if codecs is not None else None)

        # resumable run state (state_dict/load_state_dict)
        self._stacked = None
        self._round = 0
        self._edge_round = 0
        self._sim_time = 0.0
        self._test = None

        U, B = hcfg.num_clients, hcfg.num_edge_servers
        self.U, self.B, self.Ub = U, B, hcfg.clients_per_es
        # aggregation weights (paper Eq. 4/6): proportional to |D_u|
        sizes = np.array([len(i) for i in data.train_indices], np.float64)
        if hcfg.weighting == "uniform":
            sizes = np.ones_like(sizes)
        es_sizes = sizes.reshape(B, self.Ub).sum(axis=1)
        self.alpha_u = (sizes.reshape(B, self.Ub)
                        / es_sizes[:, None]).reshape(U)      # within-ES
        self.alpha_b = es_sizes / es_sizes.sum()

        # the dataset stays on the device; minibatches are gathered there
        ds = data.dataset
        self._x_train = torch.from_numpy(ds.x_train).to(self.device)
        self._y_train = torch.from_numpy(ds.y_train).to(self.device)

    # -------------------------------------------------------------- data --
    def _codec_generator(self, name: str = "") -> torch.Generator:
        """A fresh device generator for one codec application."""
        return make_generator(fold_in_str(draw_seed(self._codec_seeds), name),
                              self.device)

    def _sample_minibatches(self, batch_size: int, rng=None):
        """One (U, N, ...) stacked minibatch (client-local sampling), drawn
        exactly as the reference draws it.

        ``rng`` defaults to the training stream ``self.rng``; personalize
        passes its own stream so fine-tuning is invariant to how much
        training preceded it."""
        rng = self.rng if rng is None else rng
        idx = np.empty((self.U, batch_size), np.int64)
        for u in range(self.U):
            own = self.data.train_indices[u]
            idx[u] = own[rng.choice(len(own), size=batch_size,
                                    replace=len(own) < batch_size)]
        gi = torch.from_numpy(idx).to(self.device)
        return self._x_train[gi], self._y_train[gi]

    def _stacked_test(self, cap: int = 256):
        """Each client's first ``cap`` test samples, zero-padded, with a
        0/1 weight per sample; built once and kept on the device."""
        if self._test is None:
            xs, ys, ws = [], [], []
            for u in range(self.U):
                x, y = self.data.client_test(u % self.data.num_clients)
                n = min(len(x), cap)
                pad = cap - n
                xs.append(np.pad(x[:n], ((0, pad),) + ((0, 0),) * 3))
                yy = np.zeros(cap, np.int32)
                yy[:n] = y[:n]
                ys.append(yy)
                w = np.zeros(cap, np.float32)
                w[:n] = 1.0
                ws.append(w)
            self._test = tuple(torch.from_numpy(np.stack(a)).to(self.device)
                               for a in (xs, ys, ws))
        return self._test

    # ------------------------------------------------------------- steps --
    def _client_step(self, stacked, x, y):
        """One frozen-head SGD step of every client (Eq. 12)."""
        gen = self._codec_generator() if self.codecs is not None else None
        loss, g = split_grad_stacked(stacked, x, y, self.cut,
                                     codecs=self.codecs, generator=gen)
        lr = self.t.learning_rate
        new = {}
        for k in stacked:
            if k in cnn.HEAD_KEYS and self.t.freeze_head:
                new[k] = stacked[k]                          # Eq. (12)
            else:
                new[k] = tree_map(lambda p, gg: p - lr * gg, stacked[k],
                                  g[k])
        return new, loss

    def _offload_step(self, stacked):
        """The client block crosses the uplink through the offload codec
        before edge aggregation; each leaf draws from its own stream."""
        off = self.codecs.offload
        base = draw_seed(self._codec_seeds)
        block = {k: stacked[k] for k in cnn.client_keys_for(self.cut)}
        leaves = [off.apply(make_generator(fold_in_str(base, path),
                                           self.device), leaf)
                  for path, leaf in tree_leaves_with_path(block)]
        return {**stacked, **_unflatten(block, leaves)}

    def _head_ft_step(self, stacked, x, y):
        """Eq. (18): head-only fine-tuning step of every client."""
        feats = cnn.client_forward_stacked(stacked, x, cut="fc1")
        head = _trainable(stacked["fc2"])
        with torch.enable_grad():
            logits = cnn.server_forward_stacked({"fc2": head}, feats,
                                                cut="fc1")
            loss = cnn.nll_stacked(logits, y).mean(-1)
            g = torch.autograd.grad(loss.sum(), tree_leaves(head))
        lr = self.t.finetune_lr
        new_head = tree_map(lambda p, gg: p.detach() - lr * gg, head,
                            _unflatten(head, g))
        return {**stacked, "fc2": new_head}

    # ------------------------------------------------------- aggregation --
    def _edge_aggregate(self, stacked):
        """Eqs. (14)-(15): per-ES weighted average, broadcast back."""
        B, Ub = self.B, self.Ub
        w = torch.tensor(self.alpha_u.reshape(B, Ub), dtype=torch.float32,
                         device=self.device)

        def agg(x):
            xr = x.reshape((B, Ub) + x.shape[1:])
            wexp = w.reshape((B, Ub) + (1,) * (x.dim() - 1))
            m = (xr * wexp).sum(dim=1, keepdim=True)
            return m.expand(xr.shape).reshape(x.shape)

        return tree_map(agg, stacked)

    def _global_aggregate(self, stacked):
        """Eq. (16): CS-level weighted average over ESs, broadcast back."""
        B, Ub = self.B, self.Ub
        wu = torch.tensor(self.alpha_u.reshape(B, Ub), dtype=torch.float32,
                          device=self.device)
        wb = torch.tensor(self.alpha_b, dtype=torch.float32,
                          device=self.device)

        def agg(x):
            xr = x.reshape((B, Ub) + x.shape[1:])
            es = (xr * wu.reshape((B, Ub) + (1,) * (x.dim() - 1))).sum(dim=1)
            g = (es * wb.reshape((B,) + (1,) * (es.dim() - 1))).sum(dim=0)
            return g[None].expand(x.shape).contiguous()

        return tree_map(agg, stacked)

    # --------------------------------------------------------------- run --
    def _ensure_initialized(self):
        """Materialize the stacked client replicas on first use (init is
        deterministic in ``seed``, so a restored state overwrites this)."""
        if self._stacked is None:
            params0 = cnn.init(self.seed, self.cfg, device=self.device)
            self._stacked = tree_map(
                lambda x: x[None].expand((self.U,) + x.shape).contiguous(),
                params0)

    @torch.no_grad()
    def run(self, rounds: int | None = None, log_every: int = 5) -> FedSimResult:
        """Train up to ``rounds`` TOTAL global rounds.

        The round count is absolute, not incremental: a fresh simulator
        runs them all, while one restored by ``load_state_dict`` (or simply
        run() a second time) continues from its round cursor."""
        h, t = self.h, self.t
        rounds = rounds if rounds is not None else h.global_rounds
        self._ensure_initialized()
        stacked = self._stacked
        res = FedSimResult()
        res.total_sim_time_s = self._sim_time
        per = None

        for t2 in range(self._round, rounds):
            round_losses = []
            for _t1 in range(h.kappa1):                      # edge rounds
                for _ in range(h.kappa0):                    # local epochs
                    for _ in range(self.batches_per_epoch):  # minibatches
                        x, y = self._sample_minibatches(t.batch_size)
                        stacked, loss = self._client_step(stacked, x, y)
                        round_losses.append(loss.mean())
                if self.codecs is not None and self.codecs.offload is not None:
                    # the client block crosses the uplink lossily before
                    # every edge aggregation (Phi_off's numerics side)
                    stacked = self._offload_step(stacked)
                stacked = self._edge_aggregate(stacked)      # Eq. 14-15
            stacked = self._global_aggregate(stacked)        # Eq. 16
            self._stacked = stacked
            self._round = t2 + 1

            per = None
            if (t2 + 1) % log_every == 0 or t2 == rounds - 1:
                per = self._per_client_eval(stacked)
                # per-step means go to the host once per round, as float64
                # means of float32 values (the reference's float() per step)
                losses = torch.stack(round_losses).cpu().numpy()
                res.history.append({
                    "round": t2 + 1,
                    "train_loss": float(np.mean(losses.astype(np.float64))),
                    "test_loss": float(np.mean(per["loss"])),
                    "test_acc": float(np.mean(per["acc"]))})
        res.global_params = tree_map(lambda x: x[0], stacked)
        res.per_client_global = (per if per is not None
                                 else self._per_client_eval(stacked))
        return res

    # ----------------------------------------------------- checkpointing --
    def state_dict(self) -> dict:
        """What the trajectory depends on, in memory: the stacked client
        replicas, the round cursors, the simulated clock, the data-sampling
        RNG and (with codecs) the codec seed chain."""
        self._ensure_initialized()
        out = {"round": np.int64(self._round),
               "edge_round": np.int64(self._edge_round),
               "sim_time_s": np.float64(self._sim_time),
               "rng": rng_state_array(self.rng),
               "params": self._stacked}
        if self._codec_seeds is not None:
            out["codec_rng"] = self._codec_seeds.get_state().numpy()
        return out

    def load_state_dict(self, state: dict) -> None:
        """Restore from :meth:`state_dict`, or from the reference's own
        ``FedSim.state_dict()`` with its leaves as numpy arrays (its
        ``codec_key`` is a jax key, which no torch stream reproduces: the
        codec chain then stays where it is)."""
        def leaf(a):
            t = a if isinstance(a, torch.Tensor) else torch.from_numpy(
                np.array(a, copy=True))
            if t.shape[:1] != (self.U,):
                raise ValueError(f"params leaf of shape {tuple(t.shape)} is "
                                 f"not stacked over {self.U} clients")
            return t.detach().to(self.device, copy=True)

        self._round = int(state["round"])
        self._edge_round = int(state["edge_round"])
        self._sim_time = float(state["sim_time_s"])
        restore_rng_state(self.rng, state["rng"])
        self._stacked = tree_map(leaf, state["params"])
        if self._codec_seeds is not None and "codec_rng" in state:
            self._codec_seeds.set_state(
                torch.from_numpy(np.asarray(state["codec_rng"], np.uint8)))

    # -------------------------------------------------------------- eval --
    @torch.no_grad()
    def _per_client_eval(self, stacked):
        """Per-client masked accuracy/loss of the stacked models."""
        xt, yt, wt = self._stacked_test()
        logits = cnn.apply_stacked(stacked, xt)
        nll = cnn.nll_stacked(logits, yt)
        acc = (logits.argmax(-1) == yt).to(torch.float32)
        denom = torch.clamp(wt.sum(-1), min=1.0)
        loss = (nll * wt).sum(-1) / denom
        acc = (acc * wt).sum(-1) / denom
        return {"loss": loss.cpu().numpy(), "acc": acc.cpu().numpy()}

    # ----------------------------------------------------- personalize ----
    @torch.no_grad()
    def personalize(self, global_params, steps: int | None = None):
        """Eq. (18): per-client head-only fine-tuning of w*.

        Fine-tuning minibatches come from a dedicated numpy stream seeded
        at ``seed + 3``, so the personalized heads depend only on (seed,
        global_params), not on how much training came before."""
        steps = steps or self.t.finetune_steps
        rng = np.random.default_rng(self.seed + 3)
        stacked = tree_map(
            lambda x: x[None].expand((self.U,) + x.shape).contiguous(),
            global_params)
        for _ in range(steps):
            x, y = self._sample_minibatches(self.t.batch_size, rng=rng)
            stacked = self._head_ft_step(stacked, x, y)
        per = self._per_client_eval(stacked)
        return stacked["fc2"], per
