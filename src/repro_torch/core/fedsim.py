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

Under a non-ideal ``wireless=`` network the reference's network modes run
as they do there: the numpy scheduler (``repro_torch.wireless``) decides
each edge round's participants, the masked edge aggregation renormalizes
over them (an ES with none keeps its model), an ES outage with
``reassoc`` failover aggregates by the effective ES, a straggler's banked
update folds in late with weight alpha_u * lambda**staleness, and the
global step averages only the ESs that took part.  Population mode
samples each round's cohort of training slots from a registered
``Population`` through the ``CohortScheduler``, whose decision core runs
on the simulator's device.  ``save``/``restore`` checkpoint the whole
state, the scheduler's included, through ``checkpoint/ckpt.py``.

``telemetry=`` (a ``repro_torch.telemetry.Telemetry``, default off)
registers the reference's ``fedsim.*`` instruments (round wall time,
rounds, live and stale aggregation mass, the logged losses and accuracy)
and hands the handle to the scheduler.  Off or on, it changes no number
of the run.

``centralized_sgd`` is the paper's Genie baseline: plain SGD over the
pooled dataset.
"""

from __future__ import annotations

import time as _time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.checkpoint.rng import restore_rng_state, rng_state_array
from repro_torch.configs.base import (HierarchyConfig, TrainConfig,
                                      WirelessConfig)
from repro_torch.configs.phsfl_cnn import CNNConfig
from repro_torch.core.hierarchy import es_assignment
from repro_torch.data.loader import batch_iterator
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
                 wireless: WirelessConfig | None = None,
                 cut: str | None = None, codecs=None, telemetry=None,
                 population=None, sampling: str = "uniform", device=None):
        # population mode (repro_torch.wireless.population): hcfg.num_clients
        # becomes the COHORT size (training slots); each edge round the
        # scheduler samples that many registered clients, ES-balanced so
        # slot i's home ES stays i // Ub, and slot i trains on data shard
        # cohort[i] % data.num_clients.  Without a population the classic
        # invariant holds: one shard per permanent client.
        self.population = population
        self.sampling = sampling
        self._slot_shard = None          # (U,) per-round slot -> data shard
        if population is None:
            if data.num_clients != hcfg.num_clients:
                raise ValueError(f"data has {data.num_clients} clients, the "
                                 f"hierarchy {hcfg.num_clients}")
        else:
            if wireless is None or wireless.model == "ideal":
                raise ValueError("population mode needs a wireless config "
                                 "(the cohort sampler lives on the "
                                 "scheduler)")
            if population.num_es != hcfg.num_edge_servers:
                raise ValueError(
                    f"population has {population.num_es} edge servers but "
                    f"the hierarchy has {hcfg.num_edge_servers}")
            if wireless.staleness_lambda > 0.0:
                raise ValueError(
                    "staleness_lambda > 0 is incompatible with population "
                    "mode: the bank keys snapshots by client identity, but "
                    "training slots remap to different clients every round")
        self.device = resolve_device(device)
        self.cfg, self.data, self.h, self.t = cfg, data, hcfg, tcfg
        self.batches_per_epoch = batches_per_epoch
        # the TRAINING cut: Remark 2 makes the trajectory invariant to it;
        # the wireless side prices it per round via the cut controller
        self.cut = cut if cut is not None else cnn.DEFAULT_CUT
        if self.cut not in cnn.CUT_CANDIDATES:
            raise ValueError(f"unknown cut {self.cut!r}")
        # the TRAINING codecs: applied in the literal dataflow (activations
        # and gradients at the cut each minibatch, client-block offload
        # before every edge aggregation) AND handed to the wireless side so
        # the scheduler prices the same bits the numerics pay
        self.codecs = codecs
        self.seed = seed
        self.rng = np.random.default_rng(seed)
        # codec seed chain: one seed per codec application, disjoint from
        # the data-sampling stream and the init stream
        self._codec_seeds = (make_generator(fold_in(seed, 0xC0DEC))
                             if codecs is not None else None)

        # observability (repro_torch.telemetry): FedSim registers its own
        # fedsim.* instruments (round wall time, eval accuracy, live vs
        # stale aggregation mass) next to the scheduler's sched.* ones.
        # None (the default) skips every hook — bit-inert
        self.telemetry = telemetry

        # wireless scenario: channel + participation (None => ideal network)
        self.scheduler = None
        if wireless is not None and wireless.model != "ideal":
            self.scheduler = self._make_scheduler(wireless)
        # staleness-weighted async edge aggregation (the scheduler banks a
        # straggler's remainder; its stacked params are snapshotted at the
        # banking round and folded in at delivery with alpha_u * lambda^s)
        self.staleness_lambda = (wireless.staleness_lambda
                                 if self.scheduler is not None else 0.0)
        self._stale_params = None        # stacked (U, ...) banked snapshots

        # resumable run state (state_dict/load_state_dict, save/restore)
        self._stacked = None
        self._round = 0
        self._edge_round = 0
        self._sim_time = 0.0
        self._test = None

        U, B = hcfg.num_clients, hcfg.num_edge_servers
        self.U, self.B, self.Ub = U, B, hcfg.clients_per_es
        # aggregation weights (paper Eq. 4/6): proportional to |D_u|.  In
        # population mode slot identity changes every edge round, so these
        # are uniform placeholders that _begin_cohort_round overwrites
        if population is not None:
            sizes = np.ones(U, np.float64)
        else:
            sizes = np.array([len(i) for i in data.train_indices],
                             np.float64)
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

    def _make_scheduler(self, wireless):
        """The reference's scheduler construction: the byte accounting of
        ``core.comm`` priced by ``repro_torch.wireless.make_scheduler``,
        with a cut table when the policy adapts or candidates are named,
        and the ``CohortScheduler`` on this simulator's device in
        population mode."""
        from repro_torch.core.comm import comm_for_cnn, comm_table_for_cnn
        from repro_torch.wireless import make_scheduler
        hcfg, data, population = self.h, self.data, self.population
        # Eq. 17 is an UPPER bound, so the shared byte accounting prices
        # the index payload ceil(log2 |D_u|) at the LARGEST client dataset
        max_size = int(max(len(i) for i in data.train_indices))
        if population is not None:
            from repro_torch.wireless.population import CohortScheduler
            sched_u = population.N
            es_assign = population.es_assign
            extra = dict(cls=CohortScheduler, population=population,
                         cohort_size=hcfg.num_clients,
                         sampling=self.sampling, es_balanced=True,
                         core_device=self.device)
        else:
            sched_u = hcfg.num_clients
            es_assign = es_assignment(hcfg.num_clients, hcfg.clients_per_es)
            extra = {}
        kw = dict(dataset_size=max(max_size, 2),
                  batch_size=self.t.batch_size,
                  batches_per_epoch=self.batches_per_epoch,
                  codecs=self.codecs)
        extra["telemetry"] = self.telemetry
        if wireless.cut_policy != "fixed" or wireless.cut_candidates:
            table = comm_table_for_cnn(
                self.cfg, cuts=tuple(wireless.cut_candidates) or None, **kw)
            if wireless.cut_policy == "fixed" and self.cut not in table:
                raise ValueError(
                    f"cut_policy='fixed' would price one of "
                    f"{tuple(table)} but the training cut is "
                    f"{self.cut!r}; add it to cut_candidates")
            return make_scheduler(
                wireless, sched_u, kappa0=hcfg.kappa0, comm_table=table,
                es_assign=es_assign,
                fixed_cut=self.cut if self.cut in table else 0, **extra)
        comm = comm_for_cnn(self.cfg, cut=self.cut, **kw)
        return make_scheduler(wireless, sched_u, comm, hcfg.kappa0,
                              es_assign=es_assign, **extra)

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
        shards = self._slot_shard
        idx = np.empty((self.U, batch_size), np.int64)
        for u in range(self.U):
            own = self.data.train_indices[u if shards is None
                                          else int(shards[u])]
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

    # ---------------------------------------------------------- cohorts ---
    def _begin_cohort_round(self):
        """Population mode, top of each edge round: draw the cohort BEFORE
        the local epochs (the slots must know whose shard to train on),
        remap slot -> data shard, and recompute the Eq. 4/6 weights from
        the sampled clients' registered dataset sizes."""
        cohort = self.scheduler.sample_cohort()
        self._slot_shard = cohort % self.data.num_clients
        if self.h.weighting == "uniform":
            sizes = np.ones(self.U, np.float64)
        else:
            sizes = np.asarray(self.population.data_size,
                               np.float64)[cohort]
        es_sizes = sizes.reshape(self.B, self.Ub).sum(axis=1)
        self.alpha_u = (sizes.reshape(self.B, self.Ub)
                        / es_sizes[:, None]).reshape(self.U)
        self.alpha_b = es_sizes / es_sizes.sum()
        return cohort

    # ------------------------------------------------------- aggregation --
    def _f32(self, a) -> torch.Tensor:
        """float64 host weights -> float32 on the device, as the reference
        casts them."""
        return torch.tensor(np.asarray(a, np.float64), dtype=torch.float32,
                            device=self.device)

    def _masked_edge_weights(self, mask, stale_w=None):
        """(B, Ub) weights: alpha_u renormalized over participants, plus the
        (B,) empty-ES indicator.  A fully-participating ES keeps its alpha_u
        weights EXACTLY (no renormalization round-off), so an all-ones mask
        reproduces the ideal-network path bit-for-bit.

        ``stale_w`` (a (U,) array, lambda**staleness per client whose banked
        update was DELIVERED this round, 0 elsewhere) adds the async fold:
        each delivery joins its ES's average with raw weight
        ``alpha_u * stale_w``, and live + stale weights renormalize to sum
        to 1 together.  Returns ``(w, sw, empty)`` — ``sw`` is None on the
        exact synchronous path (``stale_w`` None), and an ES counts as empty
        only if it has neither a live participant nor a delivery."""
        B, Ub = self.B, self.Ub
        aw = self.alpha_u.reshape(B, Ub)                     # float64
        m = np.asarray(mask, np.float64).reshape(B, Ub) > 0
        raw = np.where(m, aw, 0.0)
        if stale_w is None:
            tot = raw.sum(axis=1, keepdims=True)
            full = m.all(axis=1, keepdims=True)
            w = np.where(full, aw, raw / np.where(tot > 0, tot, 1.0))
            return w, None, ~m.any(axis=1)
        sw = np.asarray(stale_w, np.float64).reshape(B, Ub)
        raw_stale = aw * sw
        tot = (raw + raw_stale).sum(axis=1, keepdims=True)
        denom = np.where(tot > 0, tot, 1.0)
        return (raw / denom, raw_stale / denom,
                ~(m | (sw > 0)).any(axis=1))

    def _edge_aggregate(self, stacked, mask=None, fallback=None, stale=None,
                        stale_w=None):
        """Eqs. (14)-(15): per-ES weighted average, broadcast back.

        With a participation ``mask`` the weights renormalize over the
        participating clients of each ES; an ES with zero participants keeps
        ``fallback`` (its model from before this edge round's local steps).
        ``stale``/``stale_w`` fold banked straggler snapshots into the same
        average with weight ``alpha_u * lambda**staleness`` (see
        ``_masked_edge_weights``)."""
        B, Ub = self.B, self.Ub
        if mask is None:
            w64, sw64 = self.alpha_u.reshape(B, Ub), None
            empty = np.zeros(B, bool)
        else:
            w64, sw64, empty = self._masked_edge_weights(mask, stale_w)
            assert fallback is not None or not empty.any()
        w = self._f32(w64)
        ws = None if sw64 is None else self._f32(sw64)
        sel = torch.as_tensor(empty, device=self.device)
        fold = stale is not None and ws is not None

        def agg(x, fb=None, st=None):
            xr = x.reshape((B, Ub) + x.shape[1:])
            wexp = w.reshape((B, Ub) + (1,) * (x.dim() - 1))
            m = (xr * wexp).sum(dim=1, keepdim=True)
            if st is not None:
                swexp = ws.reshape((B, Ub) + (1,) * (x.dim() - 1))
                m = m + (st.reshape(xr.shape) * swexp).sum(dim=1,
                                                           keepdim=True)
            out = m.expand(xr.shape)
            if fb is not None and empty.any():
                out = torch.where(
                    sel.reshape((B, 1) + (1,) * (x.dim() - 1)),
                    fb.reshape(xr.shape), out)
            return out.reshape(x.shape)

        if mask is None or fallback is None:
            return tree_map(agg, stacked)
        if fold:
            return tree_map(agg, stacked, fallback, stale)
        return tree_map(agg, stacked, fallback)

    def _mapped_edge_weights(self, mask, es_map, stale_w=None):
        """(B, U) weight matrix for an ES-outage failover round.

        ``es_map`` (``RoundReport.es_map``) sends each client's update to
        its EFFECTIVE ES, so a re-associated client joins the live ES's
        average with its own alpha_u weight, renormalized together with
        that ES's home participants (and any stale deliveries).  Returns
        ``(w, sw, empty)`` like :meth:`_masked_edge_weights`; ``empty``
        marks ESs that aggregated nothing (dead, or no participants) —
        their clients keep their fallback params."""
        B, U = self.B, self.U
        m = np.asarray(mask, np.float64) > 0
        onehot = np.zeros((B, U))
        onehot[np.asarray(es_map, int), np.arange(U)] = 1.0
        raw = onehot * np.where(m, self.alpha_u, 0.0)[None, :]
        sw = np.zeros(U) if stale_w is None else np.asarray(stale_w,
                                                            np.float64)
        raw_stale = onehot * (self.alpha_u * sw)[None, :]
        tot = (raw + raw_stale).sum(axis=1, keepdims=True)
        denom = np.where(tot > 0, tot, 1.0)
        return raw / denom, raw_stale / denom, tot[:, 0] <= 0

    def _edge_aggregate_mapped(self, stacked, mask, fallback, es_map,
                               stale=None, stale_w=None):
        """Eqs. (14)-(15) under ES failover: aggregate by EFFECTIVE ES.

        Each client receives the refreshed model of the ES it actually
        worked with this round (``es_map``); a client whose effective ES
        aggregated nothing keeps ``fallback`` — which is exactly how a dead
        ES's edge model is carried forward."""
        w64, sw64, empty = self._mapped_edge_weights(mask, es_map, stale_w)
        w = self._f32(w64)                                     # (B, U)
        ws = self._f32(sw64)
        recv = torch.as_tensor(np.asarray(es_map, np.int64),
                               device=self.device)             # (U,)
        keep_fb = torch.as_tensor(empty, device=self.device)[recv]

        def agg(x, fb, st=None):
            flat = x.reshape((self.U, -1))
            es = w @ flat                                      # (B, prod)
            if st is not None:
                es = es + ws @ st.reshape((self.U, -1))
            out = torch.where(keep_fb[:, None], fb.reshape((self.U, -1)),
                              es[recv])
            return out.reshape(x.shape)

        if stale is not None and stale_w is not None:
            return tree_map(agg, stacked, fallback, stale)
        return tree_map(agg, stacked, fallback)

    def _global_aggregate(self, stacked, es_mask=None):
        """Eq. (16): CS-level weighted average over ESs, broadcast back.

        ``es_mask`` marks ESs that had at least one participating client
        this global round; alpha_b renormalizes over them (all ESs still
        RECEIVE the broadcast).  With no participating ES at all the models
        are left untouched (no global sync happened)."""
        B, Ub = self.B, self.Ub
        wu = self._f32(self.alpha_u.reshape(B, Ub))
        if es_mask is None:
            wb64 = self.alpha_b
        else:
            m = np.asarray(es_mask, np.float64) > 0
            if not m.any():
                return stacked
            if m.all():
                wb64 = self.alpha_b                          # exact path
            else:
                raw = np.where(m, self.alpha_b, 0.0)
                wb64 = raw / raw.sum()
        wb = self._f32(wb64)

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

    def _per_client(self, mask) -> torch.Tensor:
        return torch.as_tensor(np.asarray(mask, bool), device=self.device)

    def _enabled_telemetry(self):
        """The telemetry handle when it records, else None."""
        tel = self.telemetry
        return tel if tel is not None and getattr(tel, "enabled",
                                                  False) else None

    def _network_edge_round(self, stacked, prev, cohort, res, es_any,
                            parts):
        """One scheduled edge round: the scheduler's report, its network
        row, the stale bank, and the masked (or mapped) aggregation.
        Returns the aggregated replicas."""
        tel = self._enabled_telemetry()
        rep = self.scheduler.step(self._edge_round)
        self._edge_round += 1
        if cohort is not None:
            # population-wide (N,) report -> this round's slots
            from repro_torch.wireless.population import cohort_report
            rep = cohort_report(rep, cohort)
        live = rep.mask > 0
        if rep.es_map is not None:
            # failover round: participation counts for the ES the client
            # actually worked with
            es_any |= np.bincount(rep.es_map[live], minlength=self.B) > 0
        else:
            es_any |= live.reshape(self.B, self.Ub).any(1)
        parts.append(rep.num_participants)
        self._sim_time += rep.round_time_s
        res.total_sim_time_s = self._sim_time
        row = {"edge_round": rep.round_idx,
               "participants": rep.num_participants,
               "scheduled": int(rep.scheduled.sum()),
               "round_time_s": rep.round_time_s,
               "bits": rep.bits_tx}
        if rep.mean_cut is not None:
            row["mean_cut"] = rep.mean_cut
        if rep.compute_s is not None and rep.compute_s.any():
            row["compute_s_max"] = float(rep.compute_s.max())
            row["compute_j"] = float(rep.compute_j.sum())
        if rep.crashed is not None:
            row["crashed"] = int(rep.crashed.sum())
            row["failed"] = int(rep.failed.sum())
            row["retx_bits"] = rep.retx_bits
            row["retx_j"] = rep.retx_j
        if rep.es_down is not None:
            row["es_down"] = int(rep.es_down.sum())
        # staleness-weighted async fold (lambda > 0 only): deliveries read
        # the snapshots banked in EARLIER rounds (delivered requires idle,
        # banked requires scheduled, so the two sets never overlap within
        # a round), then this round's new stragglers are snapshotted
        # BEFORE the aggregation overwrites their local models
        stale_tree = stale_w = None
        if rep.stale_delivered is not None:
            deliv = rep.stale_delivered > 0
            if deliv.any() and self._stale_params is not None:
                stale_w = np.where(
                    deliv, self.staleness_lambda ** rep.stale_delivered, 0.0)
                stale_tree = self._stale_params
                if tel is not None:
                    # pre-normalization aggregation mass the banked
                    # (discounted) updates contribute next to the live
                    # participants'
                    tel.metrics.counter("fedsim.agg_mass_stale").inc(
                        float(stale_w.sum()))
            if tel is not None:
                tel.metrics.counter("fedsim.agg_mass_live").inc(
                    float(np.asarray(rep.mask).sum()))
            row["stale_banked"] = int(rep.stale_banked.sum())
            row["stale_delivered"] = int(deliv.sum())
            row["stale_dropped"] = int(rep.stale_dropped.sum())
        res.network.append(row)
        if rep.stale_banked is not None and rep.stale_banked.any():
            if self._stale_params is None:
                self._stale_params = tree_map(torch.clone, stacked)
            else:
                sel = self._per_client(rep.stale_banked)
                self._stale_params = tree_map(
                    lambda b, x: torch.where(
                        sel.reshape((self.U,) + (1,) * (x.dim() - 1)), x, b),
                    self._stale_params, stacked)
        if rep.es_map is not None:
            # reassoc failover: aggregate by the EFFECTIVE ES
            agged = self._edge_aggregate_mapped(
                stacked, rep.mask, prev, rep.es_map, stale=stale_tree,
                stale_w=stale_w)
        else:
            agged = self._edge_aggregate(stacked, mask=rep.mask,
                                         fallback=prev, stale=stale_tree,
                                         stale_w=stale_w)
        if rep.down_failed is not None and rep.down_failed.any():
            # lost downlink: the ES has this client's update (it
            # aggregated) but the client never received the refreshed
            # edge model — it keeps its own
            keep = self._per_client(rep.down_failed)
            agged = tree_map(
                lambda new, old: torch.where(
                    keep.reshape((self.U,) + (1,) * (new.dim() - 1)),
                    old, new), agged, stacked)
        if cohort is not None:
            # registry bookkeeping: participants now hold the edge model
            # refreshed at this round
            self.population.head_slot[cohort[live]] = rep.round_idx
        return agged

    @torch.no_grad()
    def run(self, rounds: int | None = None, log_every: int = 5) -> FedSimResult:
        """Train up to ``rounds`` TOTAL global rounds.

        The round count is absolute, not incremental: a fresh simulator
        runs them all, while one restored by ``load_state_dict`` or
        ``restore`` (or simply run() a second time) continues from its
        round cursor, bit for bit: every RNG stream, the staleness bank and
        the simulated clock are state."""
        h, t = self.h, self.t
        rounds = rounds if rounds is not None else h.global_rounds
        self._ensure_initialized()
        stacked = self._stacked
        res = FedSimResult()
        res.total_sim_time_s = self._sim_time
        sched = self.scheduler
        per = None
        tel = self._enabled_telemetry()

        for t2 in range(self._round, rounds):
            t_wall = _time.perf_counter() if tel is not None else 0.0
            round_losses = []
            es_any = np.zeros(self.B, bool)
            parts = []
            for _t1 in range(h.kappa1):                      # edge rounds
                prev = stacked if sched is not None else None
                cohort = (self._begin_cohort_round()
                          if self.population is not None else None)
                for _ in range(h.kappa0):                    # local epochs
                    for _ in range(self.batches_per_epoch):  # minibatches
                        x, y = self._sample_minibatches(t.batch_size)
                        stacked, loss = self._client_step(stacked, x, y)
                        round_losses.append(loss.mean())
                if self.codecs is not None and self.codecs.offload is not None:
                    # the client block crosses the uplink lossily before
                    # every edge aggregation (Phi_off's numerics side)
                    stacked = self._offload_step(stacked)
                if sched is None:
                    stacked = self._edge_aggregate(stacked)  # Eq. 14-15
                else:                                        # masked Eq. 14-15
                    stacked = self._network_edge_round(
                        stacked, prev, cohort, res, es_any, parts)
            if sched is None:
                stacked = self._global_aggregate(stacked)    # Eq. 16
            else:                                            # masked Eq. 16
                stacked = self._global_aggregate(stacked, es_mask=es_any)
            self._stacked = stacked
            self._round = t2 + 1

            if tel is not None:
                if self.device.type == "cuda":
                    # the round's device work included
                    torch.cuda.synchronize(self.device)
                tel.metrics.histogram("fedsim.round_wall_s").observe(
                    _time.perf_counter() - t_wall)
                tel.metrics.counter("fedsim.rounds").inc()
            per = None
            if (t2 + 1) % log_every == 0 or t2 == rounds - 1:
                per = self._per_client_eval(stacked)
                # per-step means go to the host once per round, as float64
                # means of float32 values (the reference's float() per step)
                losses = torch.stack(round_losses).cpu().numpy()
                row = {"round": t2 + 1,
                       "train_loss": float(np.mean(losses.astype(np.float64))),
                       "test_loss": float(np.mean(per["loss"])),
                       "test_acc": float(np.mean(per["acc"]))}
                if sched is not None:
                    row["mean_participants"] = float(np.mean(parts))
                    row["sim_time_s"] = res.total_sim_time_s
                res.history.append(row)
                if tel is not None:
                    tel.metrics.gauge("fedsim.train_loss").set(
                        row["train_loss"])
                    tel.metrics.gauge("fedsim.test_loss").set(
                        row["test_loss"])
                    tel.metrics.gauge("fedsim.test_acc").set(row["test_acc"])
                    tel.flush(step=t2 + 1, force=True)
        res.global_params = tree_map(lambda x: x[0], stacked)
        res.per_client_global = (per if per is not None
                                 else self._per_client_eval(stacked))
        return res

    # ----------------------------------------------------- checkpointing --
    def state_dict(self) -> dict:
        """Everything the trajectory depends on: the stacked client
        replicas, the round cursors, the simulated clock, the data-sampling
        RNG, (with codecs) the codec seed chain, the scheduler's state
        (budgets, stale bank, channel/thinning/fault/population streams)
        and the banked stale snapshots, under the reference's keys."""
        self._ensure_initialized()
        out = {"round": np.int64(self._round),
               "edge_round": np.int64(self._edge_round),
               "sim_time_s": np.float64(self._sim_time),
               "rng": rng_state_array(self.rng),
               "params": self._stacked}
        if self._codec_seeds is not None:
            out["codec_rng"] = self._codec_seeds.get_state().numpy()
        if self.scheduler is not None:
            out["scheduler"] = self.scheduler.state_dict()
        if self.staleness_lambda > 0.0:
            # fixed structure whether or not a bank exists yet, so the
            # checkpoint tree shape is round-independent
            has = self._stale_params is not None
            out["stale_has"] = np.int64(has)
            out["stale_params"] = (self._stale_params if has else
                                   tree_map(torch.zeros_like, self._stacked))
        return out

    def _stacked_leaf(self, a) -> torch.Tensor:
        t = a if isinstance(a, torch.Tensor) else torch.from_numpy(
            np.array(a, copy=True))
        if t.shape[:1] != (self.U,):
            raise ValueError(f"params leaf of shape {tuple(t.shape)} is "
                             f"not stacked over {self.U} clients")
        return t.detach().to(self.device, copy=True)

    def load_state_dict(self, state: dict) -> None:
        """Restore from :meth:`state_dict`, or from the reference's own
        ``FedSim.state_dict()`` with its leaves as numpy arrays (its
        ``codec_key`` is a jax key, which no torch stream reproduces: the
        codec chain then stays where it is)."""
        self._round = int(state["round"])
        self._edge_round = int(state["edge_round"])
        self._sim_time = float(state["sim_time_s"])
        restore_rng_state(self.rng, state["rng"])
        self._stacked = tree_map(self._stacked_leaf, state["params"])
        if self._codec_seeds is not None and "codec_rng" in state:
            self._codec_seeds.set_state(
                torch.from_numpy(np.asarray(state["codec_rng"], np.uint8)))
        if self.scheduler is not None:
            self.scheduler.load_state_dict(state["scheduler"])
        if self.staleness_lambda > 0.0:
            self._stale_params = (
                tree_map(self._stacked_leaf, state["stale_params"])
                if int(state["stale_has"]) else None)

    def save(self, directory: str, step: int | None = None) -> str:
        """Atomic checkpoint of :meth:`state_dict` (step defaults to the
        global-round cursor)."""
        from repro_torch.checkpoint.ckpt import save_checkpoint
        return save_checkpoint(directory,
                               self._round if step is None else step,
                               self.state_dict())

    def restore(self, directory: str, step: int | None = None) -> int | None:
        """Load the latest (or ``step``'s) checkpoint from ``directory``
        into this simulator; returns the restored step, or None when the
        directory holds no checkpoint (fresh start)."""
        from repro_torch.checkpoint.ckpt import latest_step, load_checkpoint
        if step is None:
            step = latest_step(directory)
        if step is None:
            return None
        state = load_checkpoint(directory, step, self.state_dict())
        self.load_state_dict(state)
        return step

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


# ---------------------------------------------------------------------------
def centralized_sgd(cfg: CNNConfig, data: FederatedImageData,
                    tcfg: TrainConfig, epochs: int, seed: int = 0,
                    device=None):
    """The paper's Genie baseline: SGD over the pooled dataset.

    Plain SGD at ``tcfg.learning_rate`` over ``batch_iterator``'s
    epoch-shuffled batches of ``tcfg.batch_size`` (the reference's numpy
    stream, batch for batch), from ``cnn.init(seed)`` as ``FedSim`` draws
    it.  Returns ``(params, {"acc", "loss"})`` on the whole test set,
    computed as the reference computes them: the logits' log-softmax on
    the device, the label gather and the means in numpy.  ``device=None``
    means the card; pass ``device="cpu"`` to run on the CPU."""
    dev = resolve_device(device)
    ds = data.dataset
    params = cnn.init(seed, cfg, device=dev)
    lr = tcfg.learning_rate
    for x, y in batch_iterator(ds.x_train, ds.y_train, tcfg.batch_size,
                               seed=seed, epochs=epochs):
        p = _trainable(params)
        with torch.enable_grad():
            loss = cnn.loss_fn(p, torch.from_numpy(x).to(dev),
                               torch.from_numpy(y).to(dev))
            g = torch.autograd.grad(loss, tree_leaves(p))
        with torch.no_grad():
            params = tree_map(lambda w, gg: w.detach() - lr * gg, params,
                              _unflatten(p, g))
    with torch.no_grad():
        logits = cnn.apply(params, torch.from_numpy(ds.x_test).to(dev))
        logp = torch.log_softmax(logits, dim=-1).cpu().numpy()
        pred = logits.argmax(-1).cpu().numpy()
    acc = float((pred == ds.y_test).mean())
    loss = float(-np.take_along_axis(logp, ds.y_test[:, None].astype(np.int64),
                                     axis=1).mean())
    return params, {"acc": acc, "loss": loss}
