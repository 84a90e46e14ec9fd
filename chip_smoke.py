#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA H100 and check it.

    python3 chip_smoke.py          # from the root of a checkout, one card

Phases, each printing one JSON line (any mismatch or fault exits
non-zero; no phase's failure is caught):

1. device: the card as ``nvidia-smi --query-gpu=name,power.limit`` gives
   it (also printed as a line of its own), torch and CUDA versions;
2. build: compile every kernel of the path from the sources in the
   checkout (K1, the quantize-dequantize kernel) and time the build;
3. check: each kernel's wrapper on the card at the shapes the main path
   gives it, held with ``torch.equal`` against its plain PyTorch version
   on the same inputs; the straight-through gradient is exactly ones;
4. time: each kernel, its plain version and its bound, with CUDA events
   at the main path's shape;
5. reference: a small FedSim on the card against the same run on the CPU
   (the plain versions), on the same data and seed;
6. fedsim: the slice at the paper's full width (``CNNConfig()``, 4 ESs x
   25 clients, batch 32, int8 with stochastic rounding on all three links),
   two global rounds then ``personalize`` with K = 10, with the kernels'
   launch counts read around that run alone;
7. profile: where a training step's device time goes, and the device's
   busy share;
8. the kernels line, then ``{"ok": true, "device": {...}}`` as the last
   line.

Exits non-zero, printing no result, when there is no CUDA device or the
port's sources are not beside this script.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM HBM3 rate, from NVIDIA's H100 data sheet; the bound assumes the
# card's full 700 W limit.
HBM_BYTES_PER_S = 3.35e12
HBM_SOURCE = "NVIDIA H100 SXM data sheet: 3.35 TB/s HBM3"

# the main path's K1 shape: U clients x one client's cut activations
# (batch 32 x 16 x 16 x 64 at the default cut) or its o_bp gradient
MAIN_SHAPE = (100, 32 * 16 * 16 * 64)
CHECK_SHAPES = [(1, 7), (1, 16 * 16 * 16 * 64), MAIN_SHAPE,
                (100, 3 * 3 * 3 * 64), (100, 64), (7, 1001)]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def sync_time(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def event_ms(torch, fn, iters=30, warmup=3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def phase_device(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({"phase": "device", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0),
          "capability": list(torch.cuda.get_device_capability(0)),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0]})
    return smi


def phase_build(kernel):
    kernel.build()
    ptxas = [ln.strip() for ln in kernel.build_log.splitlines()
             if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "kernel": "quantize",
          "seconds": kernel.build_seconds, "library": kernel.library_path()
          .name, "ptxas": ptxas})


def phase_check(torch, ops, ref):
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases, bad, max_err = 0, [], 0.0
    for shape in CHECK_SHAPES:
        x = torch.randn(shape, generator=gen, device="cuda") * 3.0
        if shape[0] > 1:
            x[0] = 0.0                                 # an all-zero row
        for u_mode in ("stochastic", "half"):
            if u_mode == "stochastic":
                u = torch.rand(shape, generator=gen, device="cuda")
            else:
                u = torch.full(shape, 0.5, device="cuda")
            for bits in range(2, 9):
                qmax = 2 ** (bits - 1) - 1
                s = ops.tensor_scale(x, qmax)
                got = ops.quantize_dequantize(x, u, s, qmax)
                want = ref.quantize_dequantize_ref(x, u, s, qmax)
                cases += 1
                err = float((got - want).abs().max())
                max_err = max(max_err, err)
                if not torch.equal(got, want):
                    bad.append({"shape": shape, "u": u_mode, "bits": bits,
                                "max_abs_err": err})
    zero = torch.zeros(1, 4096, device="cuda")
    zs = ops.tensor_scale(zero, 127)
    zero_ok = bool(torch.equal(
        ops.quantize_dequantize(zero, torch.rand_like(zero), zs, 127), zero))
    xg = torch.randn(MAIN_SHAPE[0], 4096, device="cuda", requires_grad=True)
    out = ops.quantize_rows(xg, gen, bits=8)
    (g,) = torch.autograd.grad(out.sum(), [xg])
    ste_ok = bool(torch.equal(g, torch.ones_like(xg)))
    torch.cuda.synchronize()
    emit({"phase": "check", "kernel": "quantize", "cases": cases,
          "shapes": [list(s) for s in CHECK_SHAPES], "bits": [2, 8],
          "equal": not bad, "mismatches": bad, "max_abs_err": max_err,
          "zero_tensor_ok": zero_ok, "ste_grad_ones": ste_ok})
    assert not bad and zero_ok and ste_ok, "K1 disagrees with its plain version"
    return max_err


def phase_time(torch, ops, ref):
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn(MAIN_SHAPE, generator=gen, device="cuda")
    u = torch.rand(MAIN_SHAPE, generator=gen, device="cuda")
    s = ops.tensor_scale(x, 127)
    kernel_ms = event_ms(torch, lambda: ops.quantize_dequantize(x, u, s, 127))
    plain_ms = event_ms(torch,
                        lambda: ref.quantize_dequantize_ref(x, u, s, 127))
    n = x.numel()
    # x and u read once, out written once; scale (R floats) is negligible
    # but counted; 5 flops per element are far below the float32 ridge
    bytes_moved = 12 * n + 4 * x.shape[0]
    bound_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    flops = 5 * n
    row = {"phase": "time", "kernel": "quantize", "shape": list(MAIN_SHAPE),
           "dtype": "float32", "kernel_ms": kernel_ms, "plain_ms": plain_ms,
           "bound_ms": bound_ms, "bound_by": "bytes",
           "bytes": bytes_moved, "flops": flops,
           "bandwidth_source": HBM_SOURCE,
           "kernel_GBps": bytes_moved / kernel_ms / 1e6,
           "library_ms": None,
           "library_note": "no single PyTorch call computes this function: "
                           "fake_quantize_per_tensor_affine rounds half to "
                           "even and takes no uniforms and no per-row scale"}
    emit(row)
    return row


def _fedsim_parts():
    from repro_torch.compress import link_codecs
    from repro_torch.configs import CNNConfig, HierarchyConfig, TrainConfig
    from repro_torch.core.fedsim import FedSim
    from repro_torch.data import make_federated_image_data
    return (FedSim, CNNConfig, HierarchyConfig, TrainConfig,
            make_federated_image_data, link_codecs)


def phase_reference(np):
    """A small run on the card against the same run on the CPU, where every
    kernel takes its plain version.  Tolerances as in the CPU parity tests
    (tests/test_torch_fedsim.py): float32 summation order (cuDNN and
    cuBLAS against oneDNN) gives 1e-4 without a codec; with deterministic
    int8 a value on a rounding boundary may flip one quantum, 1e-2."""
    FedSim, CNNConfig, H, T, make_data, link_codecs = _fedsim_parts()
    cfg = CNNConfig(image_size=16, conv1_filters=8, conv2_filters=16,
                    fc_hidden=32)
    data = make_data(4, 0.5, image_size=16, train_per_class=30,
                     test_per_class=10, seed=0)
    h = H(num_edge_servers=2, clients_per_es=2, kappa0=2, kappa1=2)
    t = T(learning_rate=0.05, batch_size=8, finetune_steps=3,
          finetune_lr=0.05)
    worst = {}
    for name, codecs, tol in (("none", None, 1e-4),
                              ("int8-det", link_codecs(
                                  "int8", stochastic=False), 1e-2)):
        runs = []
        for device in ("cuda", "cpu"):
            sim = FedSim(cfg, data, h, t, batches_per_epoch=2, seed=0,
                         codecs=codecs, device=device)
            res = sim.run(rounds=2, log_every=1)
            heads, per = sim.personalize(res.global_params)
            runs.append(([r["train_loss"] for r in res.history]
                         + [r["test_loss"] for r in res.history],
                         res.per_client_global["loss"], per["loss"],
                         heads["w"].cpu().numpy()))
        errs = []
        for a, b in zip(*runs):
            a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
            assert np.isfinite(a).all(), name
            np.testing.assert_allclose(a, b, rtol=tol, atol=tol, err_msg=name)
            errs.append(float(np.abs(a - b).max()))
        worst[name] = {"max_abs_diff": max(errs), "tol": tol}
    emit({"phase": "reference", "cuda_vs_cpu": worst, "ok": True})


def phase_fedsim(torch, np, kernel):
    FedSim, CNNConfig, H, T, make_data, link_codecs = _fedsim_parts()
    from repro_torch.models import cnn
    cfg = CNNConfig()
    h = H(num_edge_servers=4, clients_per_es=25, kappa0=5, kappa1=3)
    t = T(batch_size=32, finetune_steps=10)
    bpe, rounds = 5, 2
    t0 = time.perf_counter()
    # CIFAR-10's size: 5000 train and 1000 test images per class
    data = make_data(h.num_clients, 0.5, train_per_class=5000,
                     test_per_class=1000, seed=0)
    data_s = time.perf_counter() - t0
    codecs = link_codecs("int8")

    torch.cuda.reset_peak_memory_stats()
    kernel.launches = 0                    # count the main path's run alone
    sim = FedSim(cfg, data, h, t, batches_per_epoch=bpe, seed=0,
                 codecs=codecs)
    per_round = []
    samples = h.num_clients * t.batch_size * h.kappa0 * h.kappa1 * bpe
    for r in range(1, rounds + 1):
        res, dt = sync_time(torch, lambda: sim.run(rounds=r, log_every=1))
        row = res.history[-1]
        per_round.append({"round": r, "wall_s": dt,
                          "samples_per_s": samples / dt,
                          "train_loss": row["train_loss"],
                          "test_loss": row["test_loss"],
                          "test_acc": row["test_acc"]})
    (heads, per), pers_s = sync_time(
        torch, lambda: sim.personalize(res.global_params))
    launches = kernel.launches
    peak = torch.cuda.max_memory_allocated()

    # one launch per leaf of the client block per edge round
    n_offload = sum(len(res.global_params[k])
                    for k in cnn.client_keys_for(sim.cut))
    steps = h.kappa0 * h.kappa1 * bpe
    expected = rounds * (2 * steps + h.kappa1 * n_offload)
    finite = all(math.isfinite(v) for r in per_round
                 for v in (r["train_loss"], r["test_loss"], r["test_acc"]))
    finite = finite and bool(np.isfinite(per["loss"]).all()
                             and np.isfinite(per["acc"]).all()
                             and np.isfinite(res.per_client_global["loss"])
                             .all())
    shapes_ok = (tuple(heads["w"].shape) == (100, 256, 10)
                 and tuple(heads["b"].shape) == (100, 10))
    emit({"phase": "fedsim", "config": {
              "model": "CNNConfig()", "U": h.num_clients,
              "B": h.num_edge_servers, "kappa0": h.kappa0,
              "kappa1": h.kappa1, "batches_per_epoch": bpe,
              "batch": t.batch_size, "codecs": "int8 stochastic, all links",
              "cut": sim.cut, "dirichlet_alpha": 0.5,
              "train_images": int(len(data.dataset.y_train))},
          "data_setup_s": data_s, "rounds": per_round,
          "samples_per_round": samples, "personalize_s": pers_s,
          "personalized_acc_mean": float(np.mean(per["acc"])),
          "global_acc_mean": float(np.mean(res.per_client_global["acc"])),
          "peak_mem_GB": peak / 1e9,
          "quantize_launches": launches,
          "quantize_launches_expected": expected,
          "finite": finite, "heads_shape_ok": shapes_ok})
    assert finite, "non-finite metrics"
    assert shapes_ok, "personalized heads have the wrong shape"
    assert launches == expected and launches > 0, (launches, expected)
    return launches, sim


def phase_profile(torch, sim, steps=3):
    """Where a training step's device time goes: kernel time by name over
    a few steps of the main path (after its counts were read), and the
    device's busy share of the window's wall time."""
    from torch.profiler import ProfilerActivity, profile
    stacked = sim._stacked
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            x, y = sim._sample_minibatches(sim.t.batch_size)
            stacked, _ = sim._client_step(stacked, x, y)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name, spans = {}, []
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            tot, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (tot + e.time_range.elapsed_us(), n + 1)
            spans.append((e.time_range.start, e.time_range.end))
    # busy = the union of kernel intervals: kernels that overlap in time
    # (on several streams) would otherwise count twice
    busy_us, reach = 0.0, float("-inf")
    for start, end in sorted(spans):
        if end > reach:
            busy_us += end - max(start, reach)
            reach = end
    kernel_us = sum(t for t, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    emit({"phase": "profile", "steps": steps,
          "profiled_step_ms": wall_us / steps / 1e3,
          "device_busy_ms_per_step": busy_us / steps / 1e3,
          "device_busy_share": busy_us / wall_us,
          "kernel_ms_sum_per_step": kernel_us / steps / 1e3,
          "top_kernels": [{"name": k[:90], "ms_per_step": t / steps / 1e3,
                           "share_of_kernel_time": t / kernel_us,
                           "calls": n}
                          for k, (t, n) in top],
          "quantize_ms_per_step": sum(
              t for k, (t, _) in by_name.items() if "qdq_f32" in k)
          / steps / 1e3})


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.device import resolve_device
    from repro_torch.hopper.quantize import kernel, ops, ref

    resolve_device("cuda")               # float32 numerics on the card
    phase_device(torch)
    phase_build(kernel)
    max_err = phase_check(torch, ops, ref)
    timing = phase_time(torch, ops, ref)
    phase_reference(np)
    launches, sim = phase_fedsim(torch, np, kernel)
    phase_profile(torch, sim)
    emit({"kernels": [{
        "name": "quantize", "route": "cuda",
        "source": "src/repro_torch/hopper/quantize/csrc/quantize.cu",
        "replaces": "src/repro/kernels/quantize/kernel.py:40",
        "launches": launches, "equal": True, "max_abs_err": max_err,
        "ms": timing["kernel_ms"], "kernel_ms": timing["kernel_ms"],
        "plain_ms": timing["plain_ms"], "bound_ms": timing["bound_ms"],
        "bound_by": "bytes", "library_ms": None}]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
