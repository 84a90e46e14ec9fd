"""Decoder-LM assembly (``repro.models.transformer``) for every decoder
architecture: global and sliding-window attention (RoPE, or Qwen2-VL's
M-RoPE), DeepSeek-V2's multi-head latent attention and the RG-LRU
recurrent block, each with a dense gated MLP or a MoE FFN; and the xLSTM
blocks (mLSTM and sLSTM, each with its own up/down projections and no MLP
sublayer).

Layers are grouped into *stages* as in the reference:

    lead  — unscanned leading layers (deepseek's first dense-FFN layer,
            the PHSFL client-side layers)
    scan  — (pattern of len p) x (repeats k), params stacked on a leading
            'stack' dim; the reference's ``lax.scan`` is a loop over it
    tail  — unscanned remainder

so parameter trees carry across unchanged.  The LM head is always a
separate parameter ("lm_head"): the PHSFL frozen random classifier.

Activation checkpointing (``remat``) has the reference's granularity:
one checkpoint per repeat of a scan stage (a whole pattern period) and
one per lead or tail layer (``remat_wrapper``); ``lm_loss`` keeps its
own per-chunk recompute.

Tensor parallelism (``par``, ``sharding.tensor_parallel``; every
family): each rank holds its block of every leaf; the embedding and the
head are split by vocabulary (the embed scale applies after the reduce;
the logits stay split; the loss's log-sum-exp is reduced over the
"model" dim), attention, MLA and the MLP by heads and width, the MoE by
experts, the RG-LRU by width and the xLSTM blocks as ``models.xlstm``
sets out.  The MoE's auxiliary loss is computed whole on every rank and
counted once.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                     create_selective_checkpoint_contexts)

from repro_torch.configs.base import (LOCAL_ATTN, MLA_ATTN, MLSTM, RGLRU,
                                      SLSTM, ModelConfig)
from repro_torch.models import attention as attn_mod
from repro_torch.models import mla as mla_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import xlstm as xlstm_mod
from repro_torch.models.init_utils import (dense, dense_axes, embedding,
                                           embedding_axes, norm, norm_axes,
                                           stack_axes)
from repro_torch.models.layers import (apply_norm, mlp_apply, mlp_axes,
                                       mlp_init, softcap)
from repro_torch.sharding import tensor_parallel as tpm
from repro_torch.telemetry import spans
from repro_torch.utils.tree import tree_map

LOSS_CHUNK = 512  # seq chunk for the memory-bounded LM loss

XLSTM_KINDS = (SLSTM, MLSTM)


# ------------------------------------------------------------- stages ------
@dataclasses.dataclass(frozen=True)
class Stage:
    which: str                 # "lead" | "scan" | "tail"
    layer_ids: tuple[int, ...] # absolute layer indices (first repeat for scan)
    repeats: int = 1


def compute_stages(cfg: ModelConfig) -> list[Stage]:
    kinds = cfg.layer_kinds()
    L = cfg.num_layers
    p = len(cfg.block_pattern)
    # lead layers are unscanned: structurally distinct layers (deepseek's
    # first dense-FFN layer) and the PHSFL client-side layers
    lead = max(cfg.moe.first_dense_layers if cfg.moe else 0,
               cfg.n_client_layers)
    lead = min(lead, L)
    k = (L - lead) // p
    rem = (L - lead) - k * p
    stages = []
    if lead:
        stages.append(Stage("lead", tuple(range(lead))))
    if k:
        first = tuple(range(lead, lead + p))
        for r in range(k):               # the pattern must actually repeat
            for j in range(p):
                assert kinds[lead + r * p + j] == kinds[lead + j], (r, j)
        stages.append(Stage("scan", first, repeats=k))
    if rem:
        stages.append(Stage("tail", tuple(range(lead + k * p, L))))
    return stages


def _layer_is_moe(cfg: ModelConfig, layer_id: int) -> bool:
    return (cfg.moe is not None
            and layer_id >= (cfg.moe.first_dense_layers or 0))


def _layer_kind(cfg: ModelConfig, layer_id: int) -> str:
    return cfg.layer_kinds()[layer_id]


def _window(cfg: ModelConfig, kind: str) -> int:
    return cfg.sliding_window if kind == LOCAL_ATTN else 0


def _rope_theta_for(cfg: ModelConfig, kind: str) -> float:
    return cfg.local_rope_theta if kind == LOCAL_ATTN else cfg.rope_theta


def _dtype(cfg: ModelConfig, dtype):
    return dtype or getattr(torch, cfg.dtype)


# ---------------------------------------------------------------- remat ----
# the batch-free matmuls: ``x @ w`` (the projections, the MLP) folds into
# aten.mm, or aten.addmm with a bias
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    """The "dots" policy, the reference's
    ``dots_with_no_batch_dims_saveable``: keep the outputs of the
    batch-free matmuls and recompute everything else, ``bmm`` included.
    The kernels are reached through ctypes, not aten, so the policy never
    sees them: their Functions run again in the recompute, as under
    "full"."""
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _dots_contexts():
    return create_selective_checkpoint_contexts(_save_dots)


def remat_wrapper(remat: bool, remat_policy: str | None = None):
    """Activation-checkpoint wrapper factory (the reference's).

    remat_policy None or "full": keep only the block's inputs and
    recompute the whole block in the backward; "dots": keep the
    batch-free matmul outputs too (``_save_dots``); any other policy means
    "full", as in the reference.  Non-reentrant ``checkpoint``: it takes
    parameter slices (views of stacked leaves), leaves that need no grad
    (frozen ones) and any output structure."""
    if not remat:
        return lambda f: f
    kw = {"use_reentrant": False}
    if remat_policy == "dots":
        kw["context_fn"] = _dots_contexts
    return lambda f: lambda *args: checkpoint(f, *args, **kw)


# -------------------------------------------------------- layer params -----
def init_layer(gen: torch.Generator, cfg: ModelConfig, layer_id: int,
               dtype=None) -> dict:
    dtype = _dtype(cfg, dtype)
    kind = _layer_kind(cfg, layer_id)
    if kind in XLSTM_KINDS:
        block_init = (xlstm_mod.slstm_init if kind == SLSTM
                      else xlstm_mod.mlstm_init)
        return {"ln1": norm(cfg.d_model, cfg.norm, dtype, gen.device),
                "block": block_init(gen, cfg, dtype)}
    p = {"ln1": norm(cfg.d_model, cfg.norm, dtype, gen.device),
         "ln2": norm(cfg.d_model, cfg.norm, dtype, gen.device)}
    if kind == MLA_ATTN:
        p["mla"] = mla_mod.mla_init(gen, cfg, dtype)
    elif kind == RGLRU:
        p["rec"] = rglru_mod.rglru_init(gen, cfg, dtype)
    else:
        p["attn"] = attn_mod.attn_init(gen, cfg, dtype)
    if _layer_is_moe(cfg, layer_id):
        p["moe"] = moe_mod.moe_init(gen, cfg, dtype)
    else:
        d_ff = cfg.moe.d_ff_dense if cfg.moe is not None else cfg.d_ff
        p["mlp"] = mlp_init(gen, cfg, d_ff=d_ff, dtype=dtype)
    return p


def layer_axes(cfg: ModelConfig, layer_id: int) -> dict:
    """``init_layer``'s tree with logical axis names for leaves."""
    kind = _layer_kind(cfg, layer_id)
    if kind in XLSTM_KINDS:
        block_axes = (xlstm_mod.slstm_axes if kind == SLSTM
                      else xlstm_mod.mlstm_axes)
        return {"ln1": norm_axes(cfg.norm), "block": block_axes(cfg)}
    a = {"ln1": norm_axes(cfg.norm), "ln2": norm_axes(cfg.norm)}
    if kind == MLA_ATTN:
        a["mla"] = mla_mod.mla_axes(cfg)
    elif kind == RGLRU:
        a["rec"] = rglru_mod.rglru_axes(cfg)
    else:
        a["attn"] = attn_mod.attn_axes(cfg)
    if _layer_is_moe(cfg, layer_id):
        a["moe"] = moe_mod.moe_axes(cfg)
    else:
        a["mlp"] = mlp_axes()
    return a


# -------------------------------------------------------- layer apply ------
def _ffn(p, cfg: ModelConfig, h, par=None):
    """The layer's FFN: (y, MoE aux loss, or None for a dense MLP)."""
    if "moe" in p:
        return moe_mod.moe_apply(p["moe"], cfg, h, par=par)
    d_ff = cfg.moe.d_ff_dense if cfg.moe is not None else cfg.d_ff
    return mlp_apply(p["mlp"], h, cfg.act, par=par, d_ff=d_ff), None


def apply_layer(p, cfg: ModelConfig, kind: str, x, *, positions=None,
                positions3=None, impl: str = "auto", par=None):
    """Full-sequence layer: pre-norm attention, MLA or RG-LRU block, then
    the MLP or MoE FFN, both residual; or a pre-norm xLSTM block,
    residual.  Returns (x, MoE aux loss or None).  impl "auto" runs the
    kernels on the card, "dense" the plain versions."""
    h = apply_norm(p["ln1"], x, cfg.norm)
    if kind == SLSTM:
        return x + xlstm_mod.slstm_block_apply(p["block"], cfg, h,
                                               par=par)[0], None
    if kind == MLSTM:
        return x + xlstm_mod.mlstm_block_apply(
            p["block"], cfg, h, impl=impl, par=par)[0], None
    if kind == MLA_ATTN:
        x = x + mla_mod.mla_apply(p["mla"], cfg, h, positions=positions,
                                  impl=impl, par=par)
    elif kind == RGLRU:
        x = x + rglru_mod.rglru_block_apply(p["rec"], cfg, h, impl=impl,
                                            par=par)[0]
    else:
        x = x + attn_mod.attn_apply(
            p["attn"], cfg, h, window=_window(cfg, kind),
            rope_theta=_rope_theta_for(cfg, kind),
            softcap=cfg.attn_logit_softcap, positions=positions,
            positions3=positions3, impl=impl, par=par)
    y, aux = _ffn(p, cfg, apply_norm(p["ln2"], x, cfg.norm), par)
    return x + y, aux


def decode_layer(p, cfg: ModelConfig, kind: str, x, cache, index: int, *,
                 positions3=None, par=None):
    """One-token decode through a layer, writing ``cache`` in place.
    Returns (x, cache)."""
    h = apply_norm(p["ln1"], x, cfg.norm)
    if kind in XLSTM_KINDS:
        fn = (xlstm_mod.slstm_block_apply if kind == SLSTM
              else xlstm_mod.mlstm_block_apply)
        y, cache = fn(p["block"], cfg, h, cache=cache, index=index, par=par)
        return x + y, cache
    if kind == MLA_ATTN:
        y, cache = mla_mod.mla_decode_attend(p["mla"], cfg, h, cache, index,
                                             par=par)
    elif kind == RGLRU:
        y, cache = rglru_mod.rglru_block_apply(p["rec"], cfg, h, cache=cache,
                                               index=index, par=par)
    else:
        y, cache = attn_mod.decode_attend(
            p["attn"], cfg, h, cache, index, window=_window(cfg, kind),
            rope_theta=_rope_theta_for(cfg, kind),
            softcap=cfg.attn_logit_softcap, positions3=positions3, par=par)
    x = x + y
    y, _ = _ffn(p, cfg, apply_norm(p["ln2"], x, cfg.norm), par)
    return x + y, cache


def init_layer_cache(cfg: ModelConfig, layer_id: int, batch: int,
                     max_len: int, dtype=torch.bfloat16, device="cpu"):
    """The layer's decode cache: a KV cache or MLA's latent cache in
    ``dtype``, or an xLSTM or RG-LRU layer's recurrent state, float32
    whatever ``dtype`` (as the reference's ``init_*_cache``)."""
    kind = _layer_kind(cfg, layer_id)
    if kind == MLA_ATTN:
        return mla_mod.init_mla_cache(cfg, batch, max_len, dtype, device)
    if kind == RGLRU:
        return rglru_mod.init_rglru_cache(cfg, batch, device)
    if kind == SLSTM:
        return xlstm_mod.init_slstm_cache(cfg, batch, device)
    if kind == MLSTM:
        return xlstm_mod.init_mlstm_cache(cfg, batch, device)
    return attn_mod.init_kv_cache(cfg, batch, max_len,
                                  window=_window(cfg, kind), dtype=dtype,
                                  device=device)


# --------------------------------------------------------- whole model -----
def init(gen: torch.Generator, cfg: ModelConfig, dtype=None) -> dict:
    """Random parameters drawn from ``gen`` on its device, in the
    reference's tree layout (scan stages stacked on a leading dim)."""
    dtype = _dtype(cfg, dtype)
    params = {
        "embed": embedding(gen, cfg.padded_vocab, cfg.d_model, dtype),
        "final_norm": norm(cfg.d_model, cfg.norm, dtype, gen.device),
        # the PHSFL head: randomly initialized; frozen during global training
        "lm_head": dense(gen, cfg.d_model, cfg.padded_vocab, dtype=dtype),
    }
    for si, st in enumerate(compute_stages(cfg)):
        if st.which == "scan":
            blocks = {}
            for j, lid in enumerate(st.layer_ids):
                reps = [init_layer(gen, cfg, lid + r * len(st.layer_ids),
                                   dtype) for r in range(st.repeats)]
                blocks[f"b{j}"] = tree_map(lambda *a: torch.stack(a), *reps)
            params[f"stage{si}"] = blocks
        else:
            params[f"stage{si}"] = {
                f"b{j}": init_layer(gen, cfg, lid, dtype)
                for j, lid in enumerate(st.layer_ids)}
    return params


def axes(cfg: ModelConfig) -> dict:
    """``init``'s tree with logical axis names for leaves (a scan stage's
    leaves lead with "stack")."""
    ax = {"embed": embedding_axes(),
          "final_norm": norm_axes(cfg.norm),
          "lm_head": dense_axes(("embed", "vocab"))}
    for si, st in enumerate(compute_stages(cfg)):
        blocks = {}
        for j, lid in enumerate(st.layer_ids):
            la = layer_axes(cfg, lid)
            blocks[f"b{j}"] = stack_axes(la) if st.which == "scan" else la
        ax[f"stage{si}"] = blocks
    return ax


def embed_tokens(params, cfg: ModelConfig, tokens, patch_embeds=None,
                 par=None):
    # F.embedding, not table[tokens]: the indexing's backward (index_put_
    # with accumulate) sums repeated tokens in a thread-dependent order on
    # the CPU, so a resumed run would not repeat the uninterrupted one
    table = params["embed"]["table"]
    if par is not None and par.tp and table.shape[0] < cfg.padded_vocab:
        x = tpm.vocab_parallel_embedding(tokens, table, par)
    else:
        x = F.embedding(tokens, table)
    if cfg.embed_scale:
        # sqrt(d_model) rounded to x's dtype before the product, as the
        # reference does (62.0, not 61.97, in bfloat16 at d_model 3840)
        x = x * torch.tensor(math.sqrt(cfg.d_model),
                             dtype=torch.float32).to(x.dtype)
    if patch_embeds is not None:
        # the VLM's stubbed frontend: precomputed patch embeddings take
        # the first num_patch_tokens positions of the sequence
        n = patch_embeds.shape[1]
        x = torch.cat([patch_embeds.to(x.dtype), x[:, n:]], dim=1)
    return x


def _stage_layers(cfg: ModelConfig, st: Stage, sp):
    """(params, kind) of every layer of a stage, in order."""
    kinds = [_layer_kind(cfg, lid) for lid in st.layer_ids]
    for r in range(st.repeats):
        pr = tree_map(lambda a: a[r], sp) if st.which == "scan" else sp
        for j, kind in enumerate(kinds):
            yield (r, j), pr[f"b{j}"], kind


def apply(params, cfg: ModelConfig, batch, *, impl: str = "auto",
          remat: bool = False, remat_policy: str | None = None, par=None):
    """Full-sequence forward to final hidden states (B,S,D).

    batch: {"tokens": (B,S) integer tensor, and for the VLM optionally
    "patch_embeds" (B,P,D) and "positions3" (B,S,3)}.  Returns (hidden,
    aux) with aux the MoE auxiliary loss summed over the MoE layers in
    layer order (float32; 0 without them).  ``remat`` checkpoints each
    scan-stage period and each unscanned layer (``remat_wrapper``).
    ``par``: this rank's tensor-parallel block (module docstring).
    """
    x = embed_tokens(params, cfg, batch["tokens"], batch.get("patch_embeds"),
                     par=par)
    positions3 = batch.get("positions3")
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    maybe_remat = remat_wrapper(remat, remat_policy)

    def layers(x, ps, kinds):
        """Layers of ``kinds`` on ``ps`` in order: (x, their aux terms)."""
        auxs = []
        for p, kind in zip(ps, kinds):
            x, a = apply_layer(p, cfg, kind, x, positions3=positions3,
                               impl=impl, par=par)
            auxs.append(a)
        return x, auxs

    for si, st in enumerate(compute_stages(cfg)):
        sp = params[f"stage{si}"]
        kinds = [_layer_kind(cfg, lid) for lid in st.layer_ids]
        if st.which == "scan":
            period = maybe_remat(lambda x, pr, kinds=kinds: layers(
                x, [pr[f"b{j}"] for j in range(len(kinds))], kinds))
            calls = [(period, tree_map(lambda a: a[r], sp))
                     for r in range(st.repeats)]
        else:
            calls = [(maybe_remat(lambda x, p, kind=kind: layers(
                x, [p], [kind])), sp[f"b{j}"])
                for j, kind in enumerate(kinds)]
        for fn, p in calls:
            x, auxs = fn(x, p)
            for a in auxs:
                if a is not None:
                    aux = aux + a
    x = apply_norm(params["final_norm"], x, cfg.norm)
    return x, aux


def _head_split(params, cfg: ModelConfig, par) -> bool:
    return (par is not None and par.tp
            and params["lm_head"]["w"].shape[1] < cfg.padded_vocab)


def logits_from_hidden(params, cfg: ModelConfig, hidden, par=None):
    """Logits in float32; under tensor parallelism with the head split by
    vocabulary, this rank's columns of them."""
    if _head_split(params, cfg, par):
        hidden = tpm.copy_to_tp(hidden, par)
    lg = hidden @ params["lm_head"]["w"]
    return softcap(lg.to(torch.float32), cfg.final_logit_softcap)


def _chunk_loss(w, h, labels, cap: float, par=None):
    lg = softcap((h @ w).to(torch.float32), cap)           # (B,c,V) f32
    if par is not None:
        return tpm.vocab_parallel_loss_sum(lg, labels, par)
    lse = torch.logsumexp(lg, dim=-1)
    gold = lg.gather(-1, labels[..., None].long())[..., 0]
    return (lse - gold).sum()


def lm_loss(params, cfg: ModelConfig, hidden, labels, par=None):
    """Memory-bounded cross-entropy: logits materialized per seq chunk of
    512 tokens and recomputed in backward (``jax.checkpoint`` in the
    reference), so one chunk's float32 logits are live at a time.  With
    the head split by vocabulary (``par``) each chunk's log-sum-exp and
    gold logit are reduced over the "model" dim, in the forward and again
    in the recompute.

    Spans (``telemetry.spans``, while recording): ``lm_loss`` and
    ``lm_loss.backward`` (args: tokens, chunks)."""
    b, s, _ = hidden.shape
    chunk = LOSS_CHUNK if s % LOSS_CHUNK == 0 else s
    w = params["lm_head"]["w"]
    on = spans.on()
    if on:
        sp = spans.open("lm_loss", tokens=b * s, chunks=s // chunk)
        mark, (hidden, w) = spans.mark_inputs(sp, hidden, w)
    split = _head_split(params, cfg, par)
    if split:
        hidden = tpm.copy_to_tp(hidden, par)
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c0 in range(0, s, chunk):
        total = total + checkpoint(
            _chunk_loss, w, hidden[:, c0:c0 + chunk],
            labels[:, c0:c0 + chunk], cfg.final_logit_softcap,
            par if split else None, use_reentrant=False)
    loss = total / (b * s)
    if on:
        loss = spans.mark_output(mark, loss)
        spans.close(sp)
    return loss


# --------------------------------------------------------------- decode ----
def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cpu") -> dict:
    cache = {}
    for si, st in enumerate(compute_stages(cfg)):
        blocks = {}
        for j, lid in enumerate(st.layer_ids):
            c = init_layer_cache(cfg, lid, batch, max_len, dtype, device)
            if st.which == "scan":
                c = tree_map(lambda a: a.expand(st.repeats, *a.shape)
                             .clone(), c)
            blocks[f"b{j}"] = c
        cache[f"stage{si}"] = blocks
    return cache


def decode_step(params, cfg: ModelConfig, token, cache, index: int, *,
                positions3=None, return_hidden: bool = False, par=None):
    """One decode step.  token: (B,1) integer tensor; index: current
    position; positions3: optional (B,1,3) M-RoPE ids of the token.
    Writes ``cache`` in place.  Returns (logits (B,1,V), cache); with
    return_hidden the first element is the final hidden state (B,1,D)
    instead (the personalized-head serving path).  ``par``: this rank's
    tensor-parallel block and cache slice (``attention.decode_attend``)."""
    x = embed_tokens(params, cfg, token, par=par)
    for si, st in enumerate(compute_stages(cfg)):
        sc = cache[f"stage{si}"]
        for (r, j), p, kind in _stage_layers(cfg, st, params[f"stage{si}"]):
            c = sc[f"b{j}"]
            if st.which == "scan":
                c = tree_map(lambda a: a[r], c)   # views: written in place
            x, _ = decode_layer(p, cfg, kind, x, c, index,
                                positions3=positions3, par=par)
    x = apply_norm(params["final_norm"], x, cfg.norm)
    if return_hidden:
        return x, cache
    return logits_from_hidden(params, cfg, x, par), cache


def prefill(params, cfg: ModelConfig, batch, *, impl: str = "auto"):
    """Full-sequence forward: logits of the last position, and the hidden
    states (the reference fills no cache here either)."""
    hidden, _ = apply(params, cfg, batch, impl=impl)
    return logits_from_hidden(params, cfg, hidden[:, -1:, :]), hidden
