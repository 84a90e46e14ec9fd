"""The paper's CNN (Sec. V-A) with explicit split-learning dataflow.

The PyTorch rendering of ``repro.models.cnn``.  At the paper's default cut
(after the first maxpool):

Client-side model  w_{u,0}:  conv1 -> relu -> maxpool
Server-side body   w_{1,bd}: conv2 -> relu -> maxpool -> fc1 -> relu
Server-side head   w_{1,hd}: fc2  (frozen in training, fine-tuned per client)

Layouts follow the reference at every public function: images and
cut-layer activations NHWC, conv weights HWIO, dense weights (in, out),
and the same parameter keys as ``init``.  Inside, a convolution runs in
NCHW, and the flatten before fc1 keeps the reference's (h, w, c) order.

Two forms of each function:

- ``*_stacked`` takes parameters with a leading client dimension U and
  inputs of shape (U, N, ...): the reference's ``jax.vmap`` over clients,
  written out.  A convolution becomes one grouped convolution with
  ``groups=U`` and a dense layer one ``torch.bmm``, so U clients cost one
  launch per layer.  Every output row depends only on its own client's
  parameters and inputs, so the sum of the per-client losses gives each
  client exactly its own gradient.
- the plain form (``client_forward``, ``apply``, ...) is one model, the
  reference's signature; it runs the stacked form with U = 1.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.phsfl_cnn import CNNConfig
from repro_torch.models.init_utils import shape_generator, truncated_normal
from repro_torch.utils.flops import conv2d_flops, dense_layer_flops
from repro_torch.utils.prng import fold_in, make_generator
from repro_torch.utils.tree import tree_map


def _conv_init(gen, k, cin, cout, dtype):
    scale = 1.0 / math.sqrt(k * k * cin)
    return {"w": truncated_normal(gen, (k, k, cin, cout), scale, dtype),
            "b": torch.zeros((cout,), dtype=dtype, device=gen.device)}


def _fc_init(gen, din, dout, dtype):
    return {"w": truncated_normal(gen, (din, dout), 1.0 / math.sqrt(din),
                                  dtype),
            "b": torch.zeros((dout,), dtype=dtype, device=gen.device)}


def _init_tree(g, cfg: CNNConfig, dtype):
    return {
        "conv1": _conv_init(g[0], 3, cfg.channels, cfg.conv1_filters, dtype),
        "conv2": _conv_init(g[1], 3, cfg.conv1_filters, cfg.conv2_filters,
                            dtype),
        "fc1": _fc_init(g[2], cfg.flat_dim, cfg.fc_hidden, dtype),
        "fc2": _fc_init(g[3], cfg.fc_hidden, cfg.num_labels, dtype),  # head
    }


def init(seed: int, cfg: CNNConfig, dtype=torch.float32, device="cpu"):
    """Random parameters from ``seed``, one stream per layer.

    They are drawn on the host, so a seed gives the same weights on every
    device, and then placed on ``device``.  The streams are torch's, not
    jax.random's: to start from the reference's weights, carry them across
    with ``repro_torch.convert.params_from_numpy``."""
    g = [make_generator(fold_in(seed, i)) for i in range(4)]
    return tree_map(lambda t: t.to(device), _init_tree(g, cfg, dtype))


def axes(cfg: CNNConfig) -> dict:
    """``init``'s tree with logical axis names for leaves."""
    return {"conv1": {"w": ("conv", "conv", None, None), "b": (None,)},
            "conv2": {"w": ("conv", "conv", None, None), "b": (None,)},
            "fc1": {"w": (None, "mlp"), "b": ("mlp",)},
            "fc2": {"w": ("mlp", None), "b": (None,)}}


def param_shapes(cfg: CNNConfig):
    """``init``'s tree with shapes and dtypes only (meta tensors): what
    the byte accounting counts, with no weight drawn."""
    return _init_tree([shape_generator()] * 4, cfg, torch.float32)


# PHSFL tree partition.  The cut candidates are the layer boundaries the
# split may fall on, shallow to deep; DEFAULT_CUT is the paper's own split
# (after the first maxpool).
CUT_CANDIDATES = ("conv1", "conv2", "fc1")
DEFAULT_CUT = "conv1"
CLIENT_KEYS = ("conv1",)
BODY_KEYS = ("conv2", "fc1")
HEAD_KEYS = ("fc2",)


def client_keys_for(cut: str) -> tuple[str, ...]:
    """Tree keys of the client block w_{u,0} when cutting after ``cut``."""
    if cut not in CUT_CANDIDATES:
        raise ValueError(f"unknown cut {cut!r}; candidates: {CUT_CANDIDATES}")
    return CUT_CANDIDATES[:CUT_CANDIDATES.index(cut) + 1]


# ------------------------------------------------- stacked (U clients) ----
# Between layers a stacked feature map is kept as one grouped NCHW tensor
# (N, U*C, H, W); client u owns channels [u*C, (u+1)*C).
def _grouped(x):
    """(U, N, H, W, C) NHWC -> grouped NCHW (N, U*C, H, W)."""
    u, n, h, w, c = x.shape
    return x.permute(1, 0, 4, 2, 3).reshape(n, u * c, h, w)


def _nhwc(h, u):
    """Grouped NCHW (N, U*C, H, W) -> (U, N, H, W, C) NHWC."""
    n, uc, hh, ww = h.shape
    return h.reshape(n, u, uc // u, hh, ww).permute(1, 0, 3, 4, 2)


def _conv(p, h, u):
    """3x3 SAME conv of every client at once: HWIO (U, k, k, I, O) weights
    -> one grouped conv with groups=U."""
    _, k, _, cin, cout = p["w"].shape
    w = p["w"].permute(0, 4, 3, 1, 2).reshape(u * cout, cin, k, k)
    return F.conv2d(h, w, p["b"].reshape(u * cout), padding=k // 2,
                    groups=u)


def _pool(h):
    return F.max_pool2d(h, kernel_size=2, stride=2)


def _dense(p, h):
    """(U, N, in) @ (U, in, out) + b; product then bias, as the reference."""
    return torch.bmm(h, p["w"]) + p["b"][:, None, :]


def _flatten(h, u):
    """Grouped NCHW -> (U, N, H*W*C) in the reference's (h, w, c) order."""
    x = _nhwc(h, u)
    return x.reshape(x.shape[0], x.shape[1], -1)


def client_forward_stacked(params, x, cut: str = DEFAULT_CUT):
    """w_{u,0} of U clients: images (U, N, H, W, C) -> o_fp at ``cut``
    ((U, N, H', W', C') NHWC after a conv block, (U, N, F) after fc1)."""
    u = x.shape[0]
    h = _pool(F.relu(_conv(params["conv1"], _grouped(x), u)))
    if cut == "conv1":
        return _nhwc(h, u)
    h = _pool(F.relu(_conv(params["conv2"], h, u)))
    if cut == "conv2":
        return _nhwc(h, u)
    if cut != "fc1":
        raise ValueError(f"unknown cut {cut!r}; candidates: {CUT_CANDIDATES}")
    return F.relu(_dense(params["fc1"], _flatten(h, u)))


def server_forward_stacked(params, o_fp, cut: str = DEFAULT_CUT):
    """w_{u,1} = [body; head] of U clients: o_fp at ``cut`` -> logits
    (U, N, labels)."""
    u = o_fp.shape[0]
    h = o_fp
    if cut == "conv1":
        h = _flatten(_pool(F.relu(_conv(params["conv2"], _grouped(h), u))),
                     u)
    elif cut == "conv2":
        h = h.reshape(h.shape[0], h.shape[1], -1)
    if cut in ("conv1", "conv2"):
        h = F.relu(_dense(params["fc1"], h))
    return _dense(params["fc2"], h)


def apply_stacked(params, x):
    return server_forward_stacked(params, client_forward_stacked(params, x))


def nll_stacked(logits, y):
    """Per-sample negative log-likelihood, (U, N)."""
    logp = F.log_softmax(logits, dim=-1)
    return -logp.gather(-1, y.long()[..., None])[..., 0]


def loss_and_acc_stacked(params, x, y):
    """Per-client mean loss and accuracy, each (U,)."""
    logits = apply_stacked(params, x)
    acc = (logits.argmax(-1) == y).to(logits.dtype).mean(-1)
    return nll_stacked(logits, y).mean(-1), acc


# ---------------------------------------------------- one model (U = 1) ----
def _one(params):
    return tree_map(lambda t: t[None], params)


def client_forward(params, x, cut: str = DEFAULT_CUT):
    """w_{u,0}: images (B,H,W,C) -> cut-layer activations o_fp at ``cut``."""
    return client_forward_stacked(_one(params), x[None], cut)[0]


def server_forward(params, o_fp, cut: str = DEFAULT_CUT):
    """w_{u,1} = [body; head]: cut activations at ``cut`` -> logits."""
    return server_forward_stacked(_one(params), o_fp[None], cut)[0]


def apply(params, x):
    return server_forward(params, client_forward(params, x))


def loss_and_acc(params, x, y):
    loss, acc = loss_and_acc_stacked(_one(params), x[None], y[None])
    return loss[0], acc[0]


def loss_fn(params, x, y):
    return loss_and_acc(params, x, y)[0]


# ------------------------------------------------------------ accounting ----
def cut_activation_size(cfg: CNNConfig, batch: int,
                        cut: str = DEFAULT_CUT) -> int:
    """Elements of o_fp for one mini-batch (Remark 1: N x Z_c) at ``cut``."""
    if cut == "conv1":
        s = cfg.image_size // 2
        return batch * s * s * cfg.conv1_filters
    if cut == "conv2":
        s = cfg.image_size // 4
        return batch * s * s * cfg.conv2_filters
    if cut == "fc1":
        return batch * cfg.fc_hidden
    raise ValueError(f"unknown cut {cut!r}; candidates: {CUT_CANDIDATES}")


def client_block_flops(cfg: CNNConfig, batch: int,
                       cut: str = DEFAULT_CUT) -> int:
    """Forward FLOPs of the client block w_{u,0} at ``cut`` for one
    mini-batch: the compute twin of :func:`cut_activation_size`.
    Convolutions are priced per output position, so a deeper cut costs
    the client far more compute even though its activation shrinks."""
    s = cfg.image_size
    f = conv2d_flops(batch, s, s, 3, cfg.channels, cfg.conv1_filters)
    if cut == "conv1":
        return f
    s2 = s // 2
    f += conv2d_flops(batch, s2, s2, 3, cfg.conv1_filters, cfg.conv2_filters)
    if cut == "conv2":
        return f
    if cut == "fc1":
        return f + dense_layer_flops(batch, cfg.flat_dim, cfg.fc_hidden)
    raise ValueError(f"unknown cut {cut!r}; candidates: {CUT_CANDIDATES}")
