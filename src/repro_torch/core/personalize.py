"""Personalization by head fine-tuning (paper Sec. III-B, Eq. 18), for the
LM head (``repro.core.personalize``).

After global training produces w*, each client fine-tunes ONLY the head
for K SGD steps on its local data; the trunk stays exactly w*.  Since the
trunk is frozen and shared, the final hidden states of every client's
batch come from ONE trunk forward over all C x B sequences (the
reference's ``vmap`` over clients, with the trunk shared), under
``torch.no_grad``; each client's K head steps then run on its slice of
them.  That holds for the MoE models too: the reference maps their
clients one at a time (``lax.map``: its grouped matmul cannot be
vmapped), but routing is per token, so the one batched pass does the
same arithmetic for every token.

``extract_head`` and ``merge_head`` take a head out of a parameter tree
and graft a (per-client) head onto the shared trunk.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.core.split import split_spec_for
from repro_torch.models import transformer as tf_mod
from repro_torch.models.registry import Model
from repro_torch.telemetry import spans
from repro_torch.utils.tree import map_with_path, path_leaves


def extract_head(params, cfg) -> dict:
    """The head subtree (paths preserved), e.g. {"lm_head": {"w": ...}}."""
    spec = split_spec_for(cfg)
    out: dict = {}
    for path, leaf in path_leaves(params):
        if spec.part_of(path) == "head":
            cur = out
            keys = path.split("/")
            for k in keys[:-1]:
                cur = cur.setdefault(k, {})
            cur[keys[-1]] = leaf
    return out


def merge_head(params, head_params, cfg):
    """Graft a (per-client) head onto shared trunk params.

    ``head_params`` may be a partial tree holding only the head paths (as
    ``extract_head`` gives it) or a full params-shaped tree."""
    spec = split_spec_for(cfg)

    def lookup(tree, path: str):
        cur = tree
        for k in path.split("/"):
            if not isinstance(cur, dict) or k not in cur:
                return None
            cur = cur[k]
        return cur

    def pick(path, leaf):
        if spec.part_of(path) != "head":
            return leaf
        h = lookup(head_params, path)
        if h is None:
            raise KeyError(f"head leaf {path} missing from head_params")
        return h

    return map_with_path(pick, params)


def head_loss(head_w, cfg: ModelConfig, hidden, labels):
    """Cross-entropy using an explicit head weight (B,S,D)x(D,V)."""
    return tf_mod.lm_loss({"lm_head": {"w": head_w}}, cfg, hidden, labels)


def _client_hidden(model: Model, params, batches):
    """Final hidden states (C,B,S,D) of every client's batch (each key
    (C,B,...): the tokens, and the VLM's patch embeddings and M-RoPE
    positions), one trunk pass over the C x B sequences."""
    c, b, s = batches["tokens"].shape
    flat = {k: v.reshape(c * b, *v.shape[2:]) for k, v in batches.items()}
    with spans.span("personalize.trunk", clients=c, tokens=c * b * s), \
            torch.no_grad():
        hidden, _ = model.apply(params, flat)
    return hidden.reshape(c, b, s, -1)


def personalize_head_bank(model: Model, params, batches, tcfg: TrainConfig):
    """Fine-tune one head per client from cached hidden states.

    batches: {"tokens": (C,B,S), "labels": (C,B,S), and for the VLM
    "patch_embeds" (C,B,P,D) and "positions3" (C,B,S,3)} tensors.
    Returns the head bank (C, D, V) in the head's dtype and per-client
    losses (C, K) float32 (the loss before each step).
    """
    with spans.span("personalize.bank", clients=batches["tokens"].shape[0],
                    steps=tcfg.finetune_steps):
        cfg = model.cfg
        hidden = _client_hidden(model, params, batches)
        w0 = params["lm_head"]["w"].detach()
        c = hidden.shape[0]
        bank = torch.empty((c, *w0.shape), dtype=w0.dtype, device=w0.device)
        losses = torch.empty((c, tcfg.finetune_steps), dtype=torch.float32,
                             device=w0.device)
        for ci in range(c):
            w = w0
            for step in range(tcfg.finetune_steps):
                with spans.span("personalize.head_step", client=ci,
                                step=step):
                    w = w.detach().requires_grad_(True)
                    loss = head_loss(w, cfg, hidden[ci],
                                     batches["labels"][ci])
                    (g,) = torch.autograd.grad(loss, [w])
                    w = w.detach() - tcfg.finetune_lr * g.to(w.dtype)
                    losses[ci, step] = loss.detach()
            bank[ci] = w
    return bank, losses


def personalized_eval(model: Model, params, head_bank, batches):
    """Per-client loss (C,) of the personalized models on held-out
    batches."""
    hidden = _client_hidden(model, params, batches)
    with torch.no_grad():
        return torch.stack([
            head_loss(head_bank[ci], model.cfg, hidden[ci],
                      batches["labels"][ci])
            for ci in range(hidden.shape[0])])
