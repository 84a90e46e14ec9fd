"""The codec family: identity, uniform int quantizer, top-k, fp8 cast.

The PyTorch rendering of ``repro.compress.codecs``.  Each codec has two
faces:

- the **numerics path**: ``encode``/``decode`` and their fused composition
  ``apply`` simulate the lossy channel in the literal split-learning
  dataflow.  The reference calls a codec once per client under ``vmap``;
  here ``x`` carries that client dimension written out: ``x[u]`` is
  client u's tensor, with its own scale or its own top-k.  Stochastic
  rounding draws from an explicit ``torch.Generator`` (on x's device)
  where the reference takes a PRNG key; deterministic codecs ignore it;
- the **byte path**: ``payload_bits(n_elements)`` is what one encoded
  tensor costs on the wire, exactly as in the reference.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import torch

from repro_torch.hopper.quantize.ops import quantize_rows, tensor_scale


def _per_row(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(R,) -> broadcastable against (R, ...) ``x``."""
    return v.reshape((-1,) + (1,) * (x.dim() - 1))


@dataclass(frozen=True)
class Codec:
    """Common API: a lossy tensor channel with exact byte accounting."""

    name = "codec"

    def __post_init__(self):
        # codecs are frozen, hashable configuration, as in the reference
        # (where they are static data under jit): reject an unhashable
        # field at construction
        for f in dataclasses.fields(self):
            value = getattr(self, f.name)
            try:
                hash(value)
            except TypeError:
                raise TypeError(
                    f"{type(self).__name__}.{f.name} must be hashable "
                    f"(codecs are static data under jit); got "
                    f"{type(value).__name__}: {value!r}") from None

    def payload_bits(self, n_elements: int) -> int:
        raise NotImplementedError

    def encode(self, generator, x):
        raise NotImplementedError

    def decode(self, enc):
        raise NotImplementedError

    def apply(self, generator, x):
        """The round trip the receiver sees: decode(encode(x))."""
        return self.decode(self.encode(generator, x))


@dataclass(frozen=True)
class IdentityCodec(Codec):
    """Full-precision passthrough: the (omega+1)-bit accounting, and a
    numerics path that is bit-identical to no codec at all.

    ``bits_per_element=None`` (the default) defers the byte accounting to
    the consuming comm model's own ``omega+1``."""

    bits_per_element: int | None = None

    name = "fp32"

    def payload_bits(self, n_elements: int) -> int:
        if self.bits_per_element is None:
            raise ValueError(
                "this IdentityCodec defers its width to the comm model's "
                "omega; construct it with an explicit bits_per_element (or "
                "get_codec('fp32', omega=...)) for standalone payload math")
        return n_elements * self.bits_per_element

    def encode(self, generator, x):
        return (x,)

    def decode(self, enc):
        return enc[0]

    def apply(self, generator, x):
        return x


@dataclass(frozen=True)
class UniformQuantCodec(Codec):
    """Symmetric uniform quantizer to ``bits``-bit integers with per-tensor
    absmax scaling and stochastic rounding.  The hot ``apply`` path is the
    quantize kernel K1 (``repro_torch.hopper.quantize``); ``encode`` /
    ``decode`` expose the integer payload itself (int8 lanes)."""

    bits: int = 8
    stochastic: bool = True
    scale_bits: int = 32             # one fp32 scale per tensor

    def __post_init__(self):
        super().__post_init__()
        # the integer payload lives in int8 lanes (encode) and the kernel
        # clips to [-qmax, qmax]; wider widths would silently wrap
        if not 2 <= self.bits <= 8:
            raise ValueError(f"uniform quantizer supports 2..8 bits, got "
                             f"{self.bits}")

    @property
    def name(self) -> str:           # type: ignore[override]
        return f"int{self.bits}"

    @property
    def qmax(self) -> int:
        return 2 ** (self.bits - 1) - 1

    def payload_bits(self, n_elements: int) -> int:
        return n_elements * self.bits + self.scale_bits

    def encode(self, generator, x):
        x2 = x.reshape(x.shape[0], -1).to(torch.float32)
        scale = tensor_scale(x2, self.qmax)
        inv = torch.where(scale > 0, 1.0 / scale, torch.zeros_like(scale))
        if self.stochastic:
            u = torch.rand(x2.shape, generator=generator,
                           dtype=torch.float32, device=x.device)
        else:
            u = torch.full(x2.shape, 0.5, dtype=torch.float32,
                           device=x.device)
        q = torch.floor(x2 * inv[:, None] + u)
        q = torch.clamp(q, -self.qmax, self.qmax).to(torch.int8)
        return (q.reshape(x.shape), scale)

    def decode(self, enc):
        q, scale = enc
        return q.to(torch.float32) * _per_row(scale, q)

    def apply(self, generator, x):
        return quantize_rows(x, generator, bits=self.bits,
                             stochastic=self.stochastic)


@dataclass(frozen=True)
class TopKCodec(Codec):
    """Magnitude top-k sparsification over each flattened tensor: ship the
    k = max(1, frac * n) largest-|x| values plus their indices; the
    receiver scatters into zeros.  Index bits are charged at ceil(log2 n)
    each."""

    frac: float = 0.05
    value_bits: int = 32

    @property
    def name(self) -> str:           # type: ignore[override]
        return f"topk{self.frac:g}"

    def k_for(self, n_elements: int) -> int:
        return max(1, int(n_elements * self.frac))

    def payload_bits(self, n_elements: int) -> int:
        k = self.k_for(n_elements)
        idx_bits = math.ceil(math.log2(max(n_elements, 2)))
        return k * (self.value_bits + idx_bits)

    def encode(self, generator, x):
        flat = x.reshape(x.shape[0], -1)
        k = self.k_for(flat.shape[1])
        _, idx = torch.topk(flat.to(torch.float32).abs(), k, dim=1)
        return (flat.gather(1, idx), idx, tuple(x.shape))

    def decode(self, enc):
        vals, idx, shape = enc
        out = torch.zeros((shape[0], math.prod(shape[1:])), dtype=vals.dtype,
                          device=vals.device)
        return out.scatter(1, idx, vals).reshape(shape)


@dataclass(frozen=True)
class Fp8Codec(Codec):
    """Per-tensor-scaled cast to float8 (e4m3): x -> (x / s) as fp8, with
    s = absmax / 448 so the tensor spans the fp8 dynamic range.  8 bits
    per element plus one fp32 scale; the cast rounds to nearest even
    (deterministic), so the generator is ignored."""

    scale_bits: int = 32

    name = "fp8"

    def payload_bits(self, n_elements: int) -> int:
        return n_elements * 8 + self.scale_bits

    def encode(self, generator, x):
        x32 = x.to(torch.float32)
        absmax = x32.reshape(x.shape[0], -1).abs().amax(dim=1)
        scale = torch.where(absmax > 0, absmax / 448.0,
                            torch.ones_like(absmax))
        return ((x32 / _per_row(scale, x)).to(torch.float8_e4m3fn), scale)

    def decode(self, enc):
        y, scale = enc
        return y.to(torch.float32) * _per_row(scale, y)


# --------------------------------------------------------------------------
@dataclass(frozen=True)
class LinkCodecs:
    """Which codec each of the three Remark-1 payloads travels through.
    ``None`` means the full-precision ``(omega+1)``-bit path."""

    activations: Codec | None = None   # cut-layer o_fp, client -> ES
    gradients: Codec | None = None     # cut-layer o_bp, ES -> client
    offload: Codec | None = None       # client-block params at round edges

    def __post_init__(self):
        for f in dataclasses.fields(self):
            value = getattr(self, f.name)
            if value is not None and not isinstance(value, Codec):
                raise TypeError(
                    f"LinkCodecs.{f.name} must be a Codec or None (static "
                    f"data under jit); got {type(value).__name__}: "
                    f"{value!r}")

    def is_lossless(self) -> bool:
        return all(c is None or isinstance(c, IdentityCodec)
                   for c in (self.activations, self.gradients, self.offload))


CODEC_NAMES = ("fp32", "int8", "int4", "topk", "fp8")


def get_codec(name: str, *, bits: int | None = None, topk_frac: float = 0.05,
              omega: int | None = None, stochastic: bool = True) -> Codec:
    """Codec presets by name (``bits`` overrides the int quantizer width).

    ``omega`` only pins the identity codec's width; left None, the identity
    codec defers to whatever ``omega`` the consuming comm model carries."""
    if name in ("fp32", "identity"):
        return IdentityCodec(
            bits_per_element=None if omega is None else omega + 1)
    if name in ("int8", "int4"):
        return UniformQuantCodec(bits=bits or int(name[3:]),
                                 stochastic=stochastic)
    if name == "topk":
        return TopKCodec(frac=topk_frac)
    if name == "fp8":
        return Fp8Codec()
    raise ValueError(f"unknown codec {name!r}; one of {CODEC_NAMES}")


def link_codecs(name: str, **kw) -> LinkCodecs:
    """The same preset codec on all three links (the common scenario)."""
    c = get_codec(name, **kw)
    return LinkCodecs(activations=c, gradients=c, offload=c)
