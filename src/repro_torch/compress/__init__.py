"""Codecs for the split-learning wire payloads (``repro.compress``)."""

from repro_torch.compress.codecs import (
    CODEC_NAMES,
    Codec,
    Fp8Codec,
    IdentityCodec,
    LinkCodecs,
    TopKCodec,
    UniformQuantCodec,
    get_codec,
    link_codecs,
)

__all__ = ["CODEC_NAMES", "Codec", "Fp8Codec", "IdentityCodec", "LinkCodecs",
           "TopKCodec", "UniformQuantCodec", "get_codec", "link_codecs"]
