"""Port parity for the kernel probes (``repro_torch.telemetry.kernels``)
in the four Hopper wrappers, on the CPU, where each wrapper takes its
kernel's plain version.

For each of K1–K4, on the same numpy inputs:
- the probe's ``flops`` and ``bytes`` equal the reference wrapper's record
  (the reference called eagerly, its Pallas kernel in interpret mode, as
  ``tests/test_telemetry.py`` calls it);
- the output is bit-equal with and without a sink;
- with no sink nothing is recorded;
- a call on the ``meta`` device is counted as traced and not timed.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.telemetry as ref_tel
import repro_torch.telemetry as port_tel
from repro_torch.hopper.flash_attention.ops import flash_attention
from repro_torch.hopper.mlstm_chunk.ops import mlstm_chunk
from repro_torch.hopper.quantize.ops import quantize_rows
from repro_torch.hopper.rglru_scan.ops import rglru_scan


def _inputs(name):
    """numpy inputs in the port's layout, and the reference's call on
    them."""
    rng = np.random.default_rng(0)
    f32 = np.float32
    if name == "quantize":
        x = rng.normal(size=(4, 256)).astype(f32)

        def ref(a):
            from repro.kernels.quantize.ops import quantize_dequantize
            return quantize_dequantize(jnp.asarray(a[0]),
                                       jax.random.PRNGKey(0), bits=8,
                                       stochastic=False)
        return (x,), ref
    if name == "flash_attention":
        b, s, h, kvh, d = 1, 128, 4, 2, 32
        q = rng.normal(size=(b, s, h, d)).astype(f32)
        k = rng.normal(size=(b, s, kvh, d)).astype(f32)
        v = rng.normal(size=(b, s, kvh, d)).astype(f32)

        def ref(a):
            from repro.kernels.flash_attention.ops import flash_attention
            return flash_attention(*map(jnp.asarray, a), True, 64, 0.0)
        return (q, k, v), ref
    if name == "mlstm_chunk":
        b, s, h, dh = 1, 128, 2, 16
        q, k, v = (rng.normal(size=(b, s, h, dh)).astype(f32)
                   for _ in range(3))
        li = rng.normal(size=(b, s, h)).astype(f32)
        lf = np.log(1 / (1 + np.exp(-rng.normal(size=(b, s, h)) - 3)))
        lf = lf.astype(f32)

        def ref(a):
            from repro.kernels.mlstm_chunk.ops import mlstm_chunk
            hm = [jnp.asarray(np.swapaxes(t, 1, 2)) for t in a]  # (B,H,S,.)
            return mlstm_chunk(*hm)
        return (q, k, v, li, lf), ref
    b, s, w = 1, 16, 128
    log_a = -np.abs(rng.normal(size=(b, s, w))).astype(f32)
    bb = rng.normal(size=(b, s, w)).astype(f32)
    h0 = rng.normal(size=(b, w)).astype(f32)

    def ref(a):
        from repro.kernels.rglru_scan.ops import rglru_scan
        return rglru_scan(*map(jnp.asarray, a))
    return (log_a, bb, h0), ref


def _port_call(name, tensors):
    if name == "quantize":
        return quantize_rows(tensors[0], None, bits=8, stochastic=False)
    if name == "flash_attention":
        return flash_attention(*tensors, causal=True, window=64)
    if name == "mlstm_chunk":
        return mlstm_chunk(*tensors)
    return rglru_scan(*tensors)


KERNELS = ["quantize", "flash_attention", "mlstm_chunk", "rglru_scan"]


@pytest.fixture(autouse=True)
def _no_sink():
    yield
    port_tel.set_kernel_sink(None)
    ref_tel.set_kernel_sink(None)


@pytest.mark.parametrize("name", KERNELS)
def test_probe_records_the_reference_work_and_changes_nothing(name):
    arrays, ref_call = _inputs(name)
    tensors = [torch.from_numpy(a) for a in arrays]
    assert port_tel.kernel_probe(name) is None
    base = _port_call(name, tensors)                 # no sink: no record

    want = port_tel.MetricsRegistry()
    ref_tel.set_kernel_sink(want)
    ref_call(arrays)
    ref_tel.set_kernel_sink(None)

    reg = port_tel.MetricsRegistry()
    port_tel.set_kernel_sink(reg)
    probed = _port_call(name, tensors)
    port_tel.set_kernel_sink(None)
    assert torch.equal(probed, base)

    snap, want_snap = reg.snapshot(), want.snapshot()
    k = f"kernel.{name}"
    for field in ("calls", "flops", "bytes"):
        assert snap[f"{k}.{field}"] == want_snap[f"{k}.{field}"], field
    assert snap[f"{k}.calls"]["value"] == 1
    assert snap[f"{k}.bytes"]["value"] == float(
        sum(t.nbytes for t in tensors) + probed.nbytes)
    assert snap[f"{k}.wall_s"]["count"] == 1
    assert snap[f"{k}.wall_s"]["min"] > 0
    assert set(snap) == set(want_snap)
    _port_call(name, tensors)                        # sink cleared
    assert reg.snapshot() == snap


@pytest.mark.parametrize("name", KERNELS)
def test_meta_call_is_counted_as_traced_and_not_timed(name):
    arrays, _ = _inputs(name)
    tensors = [torch.from_numpy(a).to("meta") for a in arrays]
    reg = port_tel.MetricsRegistry()
    port_tel.set_kernel_sink(reg)
    out = _port_call(name, tensors)
    assert out.device.type == "meta"
    assert out.shape == tensors[0].shape
    assert reg.snapshot() == {f"kernel.{name}.traced_calls": {
        "kind": "counter", "value": 1.0}}
