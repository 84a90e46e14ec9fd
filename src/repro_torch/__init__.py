"""PyTorch port of the PHSFL reproduction, for NVIDIA Hopper (H100).

The JAX package ``repro`` is the reference; this package imports none of
it (and no ``jax``).  It keeps the reference's layouts at its public
functions (images NHWC, conv weights HWIO, dense weights (in, out), the
same parameter-dict keys), so parameters carry across almost unchanged
(``repro_torch.convert``).

Slice 1 ports the paper's algorithm on its CNN: Dirichlet-split data, the
literal split exchange, frozen-head SGD over a written-out client
dimension, edge/global aggregation and head-only fine-tuning
(``repro_torch.core.fedsim.FedSim``).  Its one TPU kernel, the fused
quantize-dequantize, is a CUDA kernel under ``repro_torch.hopper``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
with no card and no ``device=`` they raise (``repro_torch.device``).
"""
