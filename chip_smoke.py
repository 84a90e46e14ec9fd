#!/usr/bin/env python3
"""Drive the PyTorch port's paths on one NVIDIA H100 and check them.

    python3 chip_smoke.py          # from the root of a checkout, one card

The paths: PHSFL training of the paper's CNN (``FedSim``, kernel K1, the
quantize-dequantize), personalized LM serving on gemma3-12b
(``launch/serve.py``, kernel K2, flash attention), personalized LM
serving on xlstm-350m (the same entry point, kernel K3, the chunkwise
mLSTM) and on recurrentgemma-2b (the same entry point, kernels K4, the
RG-LRU scan, and K2), and PHSFL training of those LMs
(``launch/train.py``: K3 on xlstm-350m, K4 and K2 on recurrentgemma-2b),
both training paths over the wireless network (the numpy scheduler
oracle, the float64 cohort core on the card, FedSim's and the launcher's
network modes: K1 and K3), and the telemetry of the CNN path and the
launcher (traces, metrics, manifests, the kernel probes: K1 and K3),
the Genie baseline (``centralized_sgd``), the six decoder LMs of the
MoE / MLA / M-RoPE slice served and trained (the same entry points:
K2 in olmoe-1b-7b's attention, deepseek-v2-236b's MLA at head width
192 and qwen2-vl-7b's M-RoPE attention), and the encoder-decoder,
seamless-m4t-medium, served and trained whole (K2 in its encoder's and
decoder's self-attention at head width 64), with activation
checkpointing (``remat``) in the host round, and the mesh rounds over
``torch.distributed`` process groups (NCCL at world size 1; four and
two ranks on the one card over gloo, K2 and K3 on their paths), and the
port's ten examples with its checkpoint and trace tools (K1, K2 and K3
on the examples' paths).  Phases, each printing one JSON line (any
mismatch or fault exits non-zero; no phase's failure is caught):

1. device: the card as ``nvidia-smi --query-gpu=name,power.limit`` gives
   it (also printed as a line of its own), torch and CUDA versions;
2. build: compile every kernel from the sources in the checkout, one
   ``nvcc`` per source, all started together, each with its time and
   ptxas report (registers, stack and spills of each kernel and
   template, and ptxas's warnings);
3. check: K1 on the card at the shapes its path gives it, held with
   ``torch.equal`` against its plain PyTorch version on the same inputs;
   the straight-through gradient is exactly ones;
4. check_flash: K2 against its plain version on the card (the
   reference's sweep, softcap, a ragged length, the bf16 kernel's tile
   edges (lengths around its 128-row and 64-key tiles at every head
   width, GQA 2:1 and MQA 10:1, window edges inside and on a key tile,
   softcap, q/k/v as slices of one fused buffer), the head bank at the
   reference's size, the serving path's shapes, recurrentgemma-2b's 10
   query heads over one kv head with its window of 2048 binding and at
   the shapes train_rglru gives it (2 and 4 x 512 tokens), head width
   192 in both dtypes, olmoe's and qwen2-vl's shapes on their paths, and
   MLA's call with v zero-padded from 128 to 192 against the plain
   version on the unpadded v, seamless's encoder (non-causal, 1024
   frames) and decoder (causal, 2048 tokens) at head width 64 at the
   batches its phases give them; 2e-5 in float32, 2e-2 in bfloat16,
   elementwise, and the whole case's relative error within 1e-5 /
   1e-2), and its backward against autograd of the plain version (also
   MLA's padded call, qwen2-vl's 7:1 GQA at 2048 tokens and seamless's
   decoder at (6, 2048, 16, 64), both in bf16);
5. time: K1, its plain version and its bound, with CUDA events;
6. time_flash: K2 at the serving path's two shapes (global and
   sliding-window layers), its plain version, its bound, the fraction of
   the bound it reaches, its rate without masks on the same inputs, and
   PyTorch's ``scaled_dot_product_attention`` on the same inputs (with
   the names of the kernels it ran); then at deepseek-v2-236b's MLA
   (6,2048,128,192, v of 128: the kernel on v zero-padded to 192, the
   plain version and SDPA on the unpadded v), olmoe-1b-7b's
   (6,2048,16,128) and seamless-m4t-medium's decoder (6,2048,16,64);
   check_flash_backward: K2's backward at one gemma3-width layer with
   8192 tokens (past the dense recompute's 4096), global and window
   1024: the blocked recompute's and the dense one's peak memory and
   their gradients' difference (K2's bf16 tolerance; the blocked peak
   below the dense logits' 4.3 GB);
7. reference: a small FedSim on the card against the same run on the CPU
   (the plain versions), on the same data and seed;
8. fedsim: the CNN path at the paper's full width (``CNNConfig()``, 4 ESs
   x 25 clients, batch 32, int8 with stochastic rounding on all three
   links), two global rounds then ``personalize`` with K = 10, with every
   kernel's launch count set to 0 just before and read just after;
9. profile: where a training step's device time goes, and the device's
   busy share, with cuDNN's default algorithms and then with the
   deterministic ones ``resolve_device`` pins (F3's repair): the step
   time before and after;
   check_cohort: the float64 cohort decision core on the card against the
   port's numpy scheduler oracle, every RoundReport field and the carried
   state bit for bit, on the CPU tests' 20 configurations x 6 rounds at
   U = 8 and on contend_prop, topk and pipeline_contend at 10**5 clients
   for 3 rounds; the ordered per-ES sum against np.bincount at 10**6
   adversarial values;
   cohort: benchmarks/cohort_bench.py's scenario at 10**6 registered
   clients over 8 k-means ESs, cohort 512 by pareto sampling: build,
   warm-up and 5 steady rounds (median, max, each split into stage A,
   stage B, copies, sampling, channel draws and the rest of the host),
   participation, peak device memory, and one round of the numpy oracle
   at the same N, whose report must equal the core's;
   reference_wireless: the CPU tests' four networks (binding deadline,
   stale fold, ES outage with reassoc failover, population mode) on a
   small FedSim, card against CPU: network rows equal, losses and
   parameters within 1e-4;
   fedsim_wireless: the CNN path at full width (as ``fedsim``) under
   cohort_bench's channel, staleness 0.5 and greedy cuts over conv1 /
   conv2 / fc1, 2 global rounds, then 100 slots sampled from 10**6
   clients over 4 k-means ESs, one round; the deadline the median of the
   oracle's round-0 times; K1's launches against their count;
   fedsim_repeat: F3, the stale_greedy run again with telemetry off and a
   run killed after round 1 and restored into a new FedSim
   (``save``/``restore``), each bit-equal to fedsim_wireless's in rows,
   clock, history and the global parameters' sum (on a difference, the
   ops ``torch.use_deterministic_algorithms(warn_only=True)`` names);
   fedsim_telemetry: fedsim_wireless's stale_greedy run (2 rounds) under
   ``Telemetry(dir, kernels=True)``, counts set to 0 just before and read
   just after: the trace's client segments of the last round against the
   scheduler's timeline as exact floats, a track per scheduled client and
   4 ES tracks, ``sched.participants`` against the rows,
   ``fedsim.rounds``, K1's probe calls against its launches (312), the
   manifest naming the card, the four files; rows, clock, history and
   the parameters' sum bit-equal to fedsim_wireless's (with telemetry
   off); the round wall times beside fedsim_wireless's;
   genie: ``centralized_sgd`` over the CNN cell's pooled data
   (``CNNConfig()``, batch 32, one epoch): loss and accuracy finite,
   accuracy above chance; a small config card against CPU within
   test_torch_fedsim.py's no-codec tolerance, the same accuracy;
10. reference_serve: ``serve()`` at ``gemma3-12b.reduced(num_layers=12)``
    on the card against the same call on the CPU, same weights and seed:
    the head bank, the logits and the generated tokens;
11. serve: the LM path at gemma3-12b's full width, cut to 12 layers (two
    of them global), the reference's serving defaults with a head bank
    over 2048-token sequences, counts set to 0 just before and read just
    after; then where one trunk forward's device time goes;
12. check_mlstm: K3 against its plain version on the card (the
    reference's sweep, the reduced model's heads of 256, the serving
    shape (6,2048,4,512) in float32 and bfloat16, the training shapes
    (2 and 8 sequences of 256 tokens, 2 and 4 of 2048) in bf16, ragged
    lengths; the
    bf16 kernel's tile edges (lengths around its 64-row tiles and
    256-row state chunks at head widths 16, 20, 48, 256 and 512, q/k/v
    as slices of one fused buffer) against the plain version on
    zero-padded rows; 2e-4 in float32, one bfloat16 step more in
    bfloat16), and its backward against autograd of the plain version;
13. time_mlstm: K3 at the serving shape, its plain version and its
    bound; in bf16 each of its three CUDA kernels alone and the floor its
    design adds (the states' traffic);
14. reference_serve_xlstm: ``serve()`` at
    ``xlstm-350m.reduced(num_layers=6)`` on the card against the same
    call on the CPU, same weights and seed;
15. serve_xlstm: the LM path at xlstm-350m's published config whole (24
    layers, d_model 1024, 4 heads of 512, vocab 50304, bf16), the
    reference's serving defaults with a head bank over 2048-token
    sequences, counts set to 0 just before and read just after; then
    where one trunk forward's time goes (device kernels, and host-clock
    seconds by block kind over three repeats on either side of the
    profile, with the main thread's CPU seconds and involuntary context
    switches: K3's mLSTM layers against the sLSTM's Python loop over
    time) and one decode step's;
16. check_rglru: K4 against its plain version on the card (the
    reference's sweep in float32 and bfloat16, the serving shape
    (6,2048,2560) in float32 from a nonzero h0, the training shapes
    (2 and 4 x 512) in float32, ragged lengths and widths; 1e-4 in
    float32, 5e-2 in bfloat16), and its backward against
    autograd through the parallel-prefix form (1e-4);
17. time_rglru: K4 at the serving shape, its plain version and its bound;
    K2 at recurrentgemma-2b's attention shape, its plain version, its
    bound and ``scaled_dot_product_attention``;
    check_probes: each of K1–K4's wrappers once at its main-path shape
    with a metrics sink: one probed call equal to one launch, the
    reference's FLOP formula, the operands' and output's bytes, one wall
    time (the wrapper's stream time, resolved before the snapshot), the
    output bit-equal to the unprobed call; the probed wall time beside
    the time phases' event time;
18. reference_serve_rglru: ``serve()`` at
    ``recurrentgemma-2b.reduced(num_layers=8)`` on the card against the
    same call on the CPU, same weights and seed;
19. serve_rglru: the LM path at recurrentgemma-2b's published config
    whole (26 layers, d_model 2560, 10 heads of 256 over one kv head,
    lru_width 2560, vocab 256000, bf16), the reference's serving defaults
    with a head bank over 2048-token sequences, counts set to 0 just
    before and read just after; then where one trunk forward's time goes
    (device kernels, and host-clock seconds by block kind: RG-LRU, local
    attention, MLP) and one decode step's;
20. reference_train: ``launch/train.train()`` at ``xlstm-350m.reduced()``
    (float32) on the card against the same call on the CPU, same
    parameters and batches, 2 rounds of 2 clients: losses, final
    parameters, head bank and both evaluations within K3's 2e-4;
    reference_train_remat: one host round of that config on the card
    under the reference's default remat ("full") against it without:
    parameters and states within 2e-4 (bit-equality reported), K3 twice
    per mLSTM layer a local step (the recompute) against once;
21. train_xlstm: PHSFL training at xlstm-350m's published widths cut to
    12 layers (bf16), 4 clients in one ES, kappa0 = 2 steps of 2 x 256 tokens, 1
    round, then the head bank and both evaluations, counts set to 0
    just before and read just after; the head frozen bit for bit, the
    clients equal after the edge step, a positive personalization gain;
    then one local step's profile (forward and backward on the host's
    clock, each block kind's share, busy share, kernel time by name; the
    same step under remat "full", which runs the sLSTM's loop twice);
    train_xlstm_2048: the same checks for one round at the published
    context of 2048 tokens, 2 clients of one local step, at the published
    widths cut to 4 layers;
22. train_rglru: recurrentgemma-2b's published widths cut to 3 layers,
    2 clients, one round of one step on 2 x 512 tokens, then a round of
    2 ESs with global_sync (Eq. 16): K4 and K2 counts, peak memory;
23. resume_train: ``launch/train.py``'s ``main`` on the card, 2 rounds
    against 1 round, abort, resume: the final state files bit-equal;
    train_wireless: the same ``main`` with ``--channel rayleigh
    --population 64 --cut-policy greedy --cut-candidates 1 2
    --erasure-prob 0.3`` on the card against the CPU (network keys equal,
    losses and state within K3's 2e-4, the scheduler's state equal), then
    killed and resumed on the card: state files bit-equal;
    train_telemetry: the same ``main`` with ``--trace-dir``, counts set to
    0 just before and read just after: its final JSON and losses equal to
    the run without, K3's probe calls equal to its launches (11), the four
    files, the ``log.train.*`` gauges;
24. reference_zoo: each of olmoe-1b-7b, deepseek-v2-236b, qwen2-vl-7b,
    command-r-plus-104b, mistral-large-123b and gemma3-27b at
    ``reduced(num_layers=3)`` (float32, the MoE widened to 8 experts,
    top-2 / top-3) on the card against the CPU, same weights: the loss
    (qwen2-vl's with patch embeddings and M-RoPE positions), a few decode
    steps' logits and a short ``serve()``, within the CPU tests' 1e-4;
    K2 once per attention layer of the card's forward;
25. serve_olmoe: the LM path at olmoe-1b-7b's published config whole
    (16 layers, 64 experts top-8, bf16) at the serving cells' traffic,
    counts set to 0 just before and read just after: 16 K2 launches at
    head width 128, the MoE's host reads of its group sizes; then the
    MoE's share of a trunk forward's kernel time and one decode step;
    serve_deepseek: deepseek-v2-236b's published widths cut to 4 layers
    (the dense first layer, 3 MoE layers of 160 experts top-6 plus 2
    shared), the same traffic: 4 K2 launches at head width 192, the
    latent cache's bytes a token and layer against an expanded cache's;
26. train_qwen2vl, train_olmoe: PHSFL training at qwen2-vl-7b's and
    olmoe-1b-7b's published widths cut to 4 layers, bf16, 2 clients x
    one local step of 1 x 2048 tokens (qwen2-vl's first 1024 its patch
    embeddings, with M-RoPE positions), then the head bank and both
    evaluations: K2 under autograd once per attention layer a forward;
27. reference_encdec: seamless-m4t-medium at ``reduced()`` (float32) on
    the card against the CPU, same weights: the loss and every gradient
    without remat, under "full" and under "dots" (K2 once per encoder and
    decoder layer a forward, twice under remat), a 12-step greedy decode
    from ``encode`` + ``precompute_cross``: the same tokens, all within
    1e-5;
28. serve_seamless: the LM path at seamless-m4t-medium's published
    config whole (12 + 12 layers, d_model 1024, 16 heads of 64, vocab
    256206, bf16, 0.98 B) at the serving cells' traffic, the bank's
    batches with 1024 source frames each, counts set to 0 just before
    and read just after: 24 K2 launches in the bank's trunk pass and 12
    in the ``encode`` that fills the decode cache's cross half, all at
    head width 64;
29. train_seamless: the whole model, 2 clients x one local step of 1 x
    2048 tokens over 1024 frames, one ``make_host_round`` without remat,
    under the default ``TrainConfig`` ("full") and under "dots": wall
    time, tokens/s, the round's peak and a local step's, K2 launches
    against the count reckoned for the policy, the params equal across
    the three, the head bank and a positive gain;
30. mesh_nccl: the mesh rounds at world size 1 over NCCL in this
    process: ``make_phsfl_round`` on xlstm-350m.reduced() (K3) at C = 1
    bit-equal to ``make_host_round`` at C = 1, and
    ``make_shared_server_step`` (four clients on the rank) on reduced
    mistral-large-123b and olmoe-1b-7b (K2) with both ``sync_clients``
    within 1e-6 of the same step on the CPU;
31. reference_mesh: ``make_phsfl_round`` on four ranks spawned on the
    one card over gloo (pod 2 x data 2 x model 1), reduced
    mistral-large-123b (K2), unmasked with global sync and under two
    masks: each client bit-equal to the port's host round on the card and
    within 1e-6 of the CPU's, K2 launches counted in each rank;
32. train_mesh_seamless: seamless-m4t-medium whole through
    ``launch/train.py``'s ``train()`` on two ranks spawned on the one card
    over gloo, one client each, one round of one local step of 1 x 2048
    tokens: the params bit-equal to the host round's (sha256 of every
    leaf), each rank's round wall time, peak, K2 launches and the seconds
    and bytes of its edge ``all_reduce``;
    steps_gemma (after mesh_nccl): the step builders
    (``launch/steps.build_step``) at gemma3-12b cut to 12 layers, full
    width, bf16, on a (data 1, model 1) mesh of one NCCL rank: prefill
    at 32768 tokens, 8 decode steps over a 32768-token cache and the
    train round at 4096 tokens (1 client x 2 local steps), each bit-equal
    to the entry point it wraps, with its time, peak and K2 launches
    against their reckoning;
    tp_gemma (inside reference_mesh's spawn, its references computed
    before it): tensor parallelism over a (data 2, model 2) mesh of the
    same four ranks, gemma3-12b at 2 layers (bf16) and reduced (float32):
    the prefill step's logits and the train round's update (after -
    before, a learning rate that lifts the bf16 update far above the
    weights' rounding) within 2e-2 / 2e-5 of model 1, the "model"
    group's ``all_reduce`` seconds and bytes, K2's launches a rank;
    tp_families (after tp_gemma, on the same ranks and mesh, its
    references computed before the spawn): olmoe-1b-7b, deepseek-v2-236b,
    recurrentgemma-2b, xlstm-350m and seamless-m4t-medium at their
    published widths cut in depth (bf16; olmoe and xlstm also in
    float32) and reduced (float32): the prefill within 2e-2 / 2e-5 of
    model 1 (with the MoE's tokens that take another expert counted),
    the train round held on its update as tp_gemma's (recurrentgemma's
    and seamless's bf16 cuts, both float32 cuts and every reduced
    config; a MoE round replays model 1's expert choices), the "model"
    group's collectives by kind, K2 / K3 / K4 launches a rank;
    dryrun: the port's dry run of gemma3-12b x the four shapes
    and deepseek-v2-236b at train_4k on the (16, 16) mesh over a fake
    group of 256 ranks, fake CUDA tensors: each record's terms, traced
    against analytic FLOPs and collectives, the traced peak, no K2
    launch;
33. examples (last): each ``examples/port_*.py``'s ``main`` in this
    process on the card at the reference example's own arguments,
    counts set to 0 just before each and read just after (one JSON line
    an example: wall seconds, K1-K4 launches against their reckoning,
    the numbers it printed): K1 in compressed_phsfl's int8 runs, K2 in
    quickstart (gemma3-12b reduced), K3 in serve_personalized
    (xlstm-350m reduced); the scheduler-only examples' stdout equal to a
    child process's without a card; personalized_federation's PHSFL
    gain above 0; the multipod dry run's child exits 0; then the
    Makefile's port-resume-smoke (``RESUME_ARGS`` through
    ``launch.train``'s ``main`` three times, the state directories
    bit-identical under ``tools/port_ckpt_diff.py``) and
    port-trace-smoke (``tools/check_trace.py`` exit 0 on the
    ``--trace-dir`` run), K3's launches in each run against theirs;
34. the kernels line (each kernel's launches on its serving or CNN path,
    on each training phase as that phase read them, on the network
    phases, the telemetry phases, the zoo's and seamless's, on the mesh
    phases by run and by rank, on the launch tools' phases, on each
    example, with each probe's wall time), then
    ``{"ok": true, "device": {...}}`` as the last line.

Exits non-zero, printing no result, when there is no CUDA device or the
port's sources are not beside this script.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM HBM3 rate, from NVIDIA's H100 data sheet; the bound assumes the
# card's full 700 W limit.
HBM_BYTES_PER_S = 3.35e12
HBM_SOURCE = "NVIDIA H100 SXM data sheet: 3.35 TB/s HBM3"
# dense bfloat16 tensor-core rate, same sheet and limit
BF16_FLOPS = 989e12

# the main path's K1 shape: U clients x one client's cut activations
# (batch 32 x 16 x 16 x 64 at the default cut) or its o_bp gradient
MAIN_SHAPE = (100, 32 * 16 * 16 * 64)
CHECK_SHAPES = [(1, 7), (1, 16 * 16 * 16 * 64), MAIN_SHAPE,
                (100, 3 * 3 * 3 * 64), (100, 64), (7, 1001)]

# K2 on the serving path: the head bank's one trunk forward over 3 clients
# x 2 sequences x 2048 tokens at gemma3-12b's width (16 query heads over 8
# kv heads of 256), bf16; sliding-window layers (1024) and global ones
FLASH_MAIN = dict(b=6, s=2048, h=16, kvh=8, d=256)
FLASH_LAYERS = {"global": 0, "local": 1024}
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# ||got - want|| / ||want|| over a whole case, beside the elementwise
# tolerance: at the serving shapes a row averages ~1024 values of
# V ~ N(0, 1), so its outputs are ~0.05 and FLASH_TOL alone would pass a
# key tile dropped at a window's edge
FLASH_REL_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
# lengths around the bf16 kernel's 128-row query and 64-key tiles
FLASH_EDGE_LENGTHS = (1, 63, 65, 127, 129, 2049)

# K3 on the xlstm-350m serving path: the head bank's one trunk forward over
# 3 clients x 2 sequences x 2048 tokens, 4 heads of dh = 2048 / 4 = 512,
# q, k, v (B,S,H,dh) in bf16, gates (B,S,H) float32
MLSTM_MAIN = dict(b=6, s=2048, h=4, dh=512)
# the reference's 2e-4 (tests/test_kernels.py:104) in float32; bfloat16
# output rounded once on both sides: one bf16 step (2^-7 relative) more
MLSTM_TOL = {"float32": dict(rtol=2e-4, atol=2e-4),
             "bfloat16": dict(rtol=2.0 ** -7, atol=2e-4)}
FP32_FLOPS = 67e12       # float32 outside the tensor cores, same sheet
# the bf16 kernel's tile edges: lengths around its 64-row tiles and
# 256-row state chunks, head widths below, off and inside its 64-column
# boxes (20: padded with zero columns), and the models' 256 and 512
MLSTM_EDGE_LENGTHS = (63, 64, 65, 255, 256, 257, 2049)
MLSTM_EDGE_WIDTHS = (16, 20, 48, 256, 512)
# F1: K2's backward at one gemma3-width layer past DENSE_MAX_SEQ; one
# float32 (1, 16, 8192, 8192) logits tensor of the dense recompute
FLASH_BWD = dict(b=1, s=8192, h=16, kvh=8, d=256)
FLASH_BWD_WINDOWS = (0, 1024)
DENSE_LOGITS_BYTES = 16 * 8192 * 8192 * 4
# ||blocked - dense|| / ||dense|| of each gradient, beside the elementwise
# bf16 tolerance: the sound runs read at most 1.05e-4 (both sides round
# float32 gradients to bf16 once); a block that misses 64 keys at its
# window's edge stays within the elementwise 2e-2
FLASH_BWD_REL_TOL = 1e-3
# host-clock repeats of the xlstm trunk forward on either side of its
# profile (its time spreads widely)
FORWARD_REPEATS = 3

# K4 on the recurrentgemma-2b serving path: the head bank's one trunk
# forward over 3 clients x 2 sequences x 2048 tokens at lru_width 2560;
# log_a, b (B,S,W) and h0 (B,W) float32
RGLRU_MAIN = dict(b=6, s=2048, w=2560)
RGLRU_TOL = {"float32": 1e-4, "bfloat16": 5e-2}   # tests/test_kernels.py:75
# K2 at recurrentgemma-2b's attention: 10 query heads over one kv head of
# 256, window 2048 (the serving path's 2048 tokens do not reach past it)
FLASH_MQA = dict(b=6, s=2048, h=10, kvh=1, d=256)
RGLRU_WINDOW = 2048
# host-clock repeats of the recurrentgemma trunk forward before its profile
RGLRU_FORWARD_REPEATS = 2

# LM training (launch/train.py).  reference_train: the reduced xlstm-350m
# (float32, so K3's float32 route) on the card against the CPU, at the
# verify recipe's flags.  Tolerance from K3's: the reference's mLSTM 2e-4
# (MLSTM_TOL["float32"]) on losses, parameters, heads and evaluations.
TRAIN_REFERENCE = dict(rounds=2, clients=2, local_steps=2, micro=2, seq=64,
                       lr=0.05, finetune_steps=5, seed=0)
TRAIN_TOL = MLSTM_TOL["float32"]
# train_xlstm: the whole published config on the reference CLI's traffic
# (4 clients in 1 ES, kappa0 = 2 steps of micro-batch 2, 5 head steps), 1
# round (a second repeats the first's work, ~44 s of the script's 1200 s
# limit); 256 tokens (not 2048: the sLSTM's Python loop over time sets the
# time) and the paper's eta = 0.01 (TrainConfig's default)
TRAIN_XLSTM = dict(rounds=1, clients=4, local_steps=2, micro=2, seq=256,
                   lr=0.01, finetune_steps=5, seed=0)
# train_xlstm_2048: one round at the published context of 2048 tokens
# (eight of K3's 256-row state chunks a sequence), cut to 2 clients of one
# local step: a round of the CLI's 4 clients x 2 steps at 2048 tokens took
# 370-448 s on the H100's host (PERF.md), most of the 1200 s this script has
TRAIN_XLSTM_CONTEXT = dict(TRAIN_XLSTM, rounds=1, clients=2, local_steps=1,
                           seq=2048)
# ... and cut in depth to 4 layers (2 mLSTM, 2 sLSTM): whole, its round
# took 91-116 s on the H100's host, a sixth of the script's time, which
# tp_families needs (PERF.md §6)
TRAIN_XLSTM_CONTEXT_LAYERS = 4
# train_xlstm at the published widths cut to 12 layers (6 mLSTM, 6 sLSTM):
# whole, its round and step profile took ~80 s on the H100's host, and
# with the examples phase the script read 893.5 s of the 900 s it is
# held to (PERF.md §6)
TRAIN_XLSTM_LAYERS = 12
# host-clock repeats of the profiled local step's forward and backward
TRAIN_STEP_REPEATS = 2
# train_rglru: recurrentgemma-2b's published widths cut to 3 layers
# (RG-LRU, RG-LRU, local attention), 2 clients, 1 round of one step on
# 2 x 512 tokens (K4's backward is a Python loop over S)
TRAIN_RGLRU_LAYERS = 3
TRAIN_RGLRU = dict(rounds=1, clients=2, local_steps=1, micro=2, seq=512,
                   lr=0.01, finetune_steps=5, seed=0)
# resume_train: launch/train.py's main at the reduced config, as the
# reference's ``make resume-smoke`` on the ideal network
RESUME_FLAGS = ["--rounds", "2", "--clients", "2", "--seq", "64",
                "--ckpt-every", "1"]

# the MoE / MLA / M-RoPE slice: its six architectures.  reference_zoo
# runs each at reduced(num_layers=3), float32, its MoE widened as the CPU
# tests widen it (reduced() routes every token to every expert), within
# the CPU tests' 1e-4
ZOO_ARCHS = ("olmoe-1b-7b", "deepseek-v2-236b", "qwen2-vl-7b",
             "command-r-plus-104b", "mistral-large-123b", "gemma3-27b")
ZOO_WIDENED = {"olmoe-1b-7b": dict(num_experts=8, top_k=2),
               "deepseek-v2-236b": dict(num_experts=8, top_k=3)}
ZOO_REFERENCE_LAYERS = 3
ZOO_TOL = 1e-4
# the serving cells' traffic (the reference's serving defaults, the bank
# on 2 x 2048 tokens a client), for serve_olmoe and serve_deepseek
SERVE_CELL = dict(batch=4, steps=16, clients=3, prompt_len=16, seed=0,
                  bank_seq=2048)
# serve_deepseek: the published widths cut to the first dense layer and
# 3 MoE layers (about 13.3 B parameters, 27 GB in bf16)
DEEPSEEK_LAYERS = 4
# train_qwen2vl / train_olmoe: published widths cut to 4 layers, 2
# clients x one local step of 1 x 2048 tokens
TRAIN_ZOO_LAYERS = 4
TRAIN_ZOO = dict(rounds=1, clients=2, local_steps=1, micro=1, seq=2048,
                 lr=0.01, finetune_steps=5, seed=0)
# K2 on the zoo's paths: olmoe's head bank (16 heads of 128, MHA);
# deepseek's MLA (128 heads, q/k of 128 + 64, v of 128, zero-padded to
# 192 for K2); qwen2-vl's 28 query heads over 4 kv heads of 128 (7:1)
FLASH_OLMOE = dict(b=6, s=2048, h=16, kvh=16, d=128)
FLASH_MLA = dict(b=6, s=2048, h=128, kvh=128, d=192, dv=128)
FLASH_QWEN = dict(s=2048, h=28, kvh=4, d=128)

# the encoder-decoder and remat slice: seamless-m4t-medium's attention (16
# heads of 64, MHA) in the encoder over 1024 frames and the decoder over
# 2048 tokens, at the head bank's 6 sequences
FLASH_SEAMLESS_ENCODER = dict(b=6, s=1024, h=16, kvh=16, d=64)
FLASH_SEAMLESS = dict(b=6, s=2048, h=16, kvh=16, d=64)
# reference_encdec: reduced() (float32) on the card against the CPU, the
# CPU tests' 1e-5, a decode of 12 steps; under each remat policy
ENCDEC_TOL = 1e-5
ENCDEC_STEPS = 12
REMAT_POLICIES = {"none": {}, "full": dict(remat=True),
                  "dots": dict(remat=True, remat_policy="dots")}
# train_seamless: the whole model, 2 clients x one local step of 1 x 2048
# tokens over 1024 source frames, one round through make_host_round,
# under the reference's default TrainConfig ("full"), "dots" and none
TRAIN_SEAMLESS = dict(clients=2, local_steps=1, micro=1, seq=2048, seed=0)
# the mesh slice.  mesh_nccl: world size 1 over NCCL, the xlstm mesh round
# at C = 1 and the shared-server step of four clients on the one rank,
# that step against the CPU within MESH_TOL; reference_mesh: four ranks
# on the one card over gloo, (pod 2, data 2, model 1), uneven weights,
# unmasked and under two masks; train_mesh_seamless: the whole model on
# two ranks through train(), one client each (lr and head steps: the
# reference's TrainConfig)
MESH_TOL = 1e-6
MESH_XLSTM = dict(local_steps=2, micro=2, seq=64)
MESH_SHARED = dict(clients=4, micro=2, seq=32)
MESH_SHARED_ARCHS = ("mistral-large-123b", "olmoe-1b-7b")
MESH_REFERENCE = dict(arch="mistral-large-123b", clients=4, local_steps=2,
                      micro=2, seq=32)
MESH_ALPHA_U = (0.25, 0.75, 0.5, 0.5)
MESH_ALPHA_B = (0.3, 0.3, 0.7, 0.7)
MESH_MASKS = {"two_lost": (1.0, 0.0, 1.0, 0.0),
              "es_empty": (0.0, 0.0, 1.0, 1.0)}
TRAIN_MESH_SEAMLESS = dict(rounds=1, clients=2, local_steps=1, micro=1,
                           seq=2048, seed=0, lr=0.01, finetune_steps=10)


def train_batches(kw) -> tuple:
    """The batch sizes a training run hands the kernels: ``micro`` in a
    local step, clients x micro in the head bank's and the evaluations'
    one trunk forward."""
    return kw["micro"], kw["clients"] * kw["micro"]


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


def short_name(mangled: str) -> str:
    """``flash_fwd_bf16<256>`` from an Itanium-mangled kernel name: the
    last name of its nested name, with an integer template argument."""
    i = 3 if mangled.startswith("_ZN") else 2
    name = None
    while i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        n = int(mangled[i:j])
        name, i = mangled[j:j + n], j + n
    arg = re.match(r"ILi(\d+)E", mangled[i:])
    if name and arg:
        name += f"<{arg.group(1)}>"
    return name or mangled


def ptxas_report(log: str) -> list:
    """Registers, stack and spills of each kernel, from ``nvcc
    -Xptxas=-v`` output."""
    rows, cur = [], None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            cur = {"function": short_name(m.group(1))}
            rows.append(cur)
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m and cur is not None:
            cur.update(stack_bytes=int(m.group(1)),
                       spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", ln)
        if m and cur is not None:
            cur["registers"] = int(m.group(1))
    return rows


def phase_build(kernels):
    """One nvcc per source, all started together (each build is a
    subprocess; the threads only wait on them)."""
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(kernels)) as ex:
        futures = [ex.submit(k.build) for k in kernels.values()]
        for f in futures:
            f.result()
    wall = time.perf_counter() - t0
    for name, kernel in kernels.items():
        emit({"phase": "build", "kernel": name,
              "seconds": kernel.build_seconds, "all_builds_wall_s": wall,
              "library": kernel.library_path().name,
              "ptxas": ptxas_report(kernel.build_log),
              "ptxas_warnings": [ln.strip() for ln in
                                 kernel.build_log.splitlines()
                                 if "warning" in ln.lower()]})


def reset_counts(kernels) -> None:
    for kernel in kernels.values():
        kernel.launches = 0


def read_counts(kernels) -> dict:
    return {name: kernel.launches for name, kernel in kernels.items()}


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


def phase_fedsim(torch, np, kernels):
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
    reset_counts(kernels)                  # count this path's run alone
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
    counts = read_counts(kernels)
    launches = counts["quantize"]
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
          "launches": counts, "quantize_launches_expected": expected,
          "finite": finite, "heads_shape_ok": shapes_ok})
    assert finite, "non-finite metrics"
    assert shapes_ok, "personalized heads have the wrong shape"
    assert launches == expected and launches > 0, (launches, expected)
    assert (counts["flash_attention"] == counts["mlstm_chunk"]
            == counts["rglru_scan"] == 0), counts
    return launches, sim


def kernel_breakdown(torch, fn, steps):
    """Run ``fn`` ``steps`` times under the profiler, tracing the device
    alone (host-side tracing of every operator would stretch the wall
    time): wall time, the device's busy time (the union of kernel
    intervals: kernels that overlap in time would otherwise count twice)
    and kernel time by name.  The device events are read from the
    profiler's raw results, without building its event tree (a window may
    hold half a million kernels)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    raw = getattr(prof.profiler, "kineto_results", None)
    if raw is None:
        raise RuntimeError(
            "this torch's profiler has no kineto_results (a private "
            "attribute of torch.autograd.profiler.profile); read the "
            "device events through prof.events() instead")
    by_name, spans = {}, []
    for e in raw.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            start, dur = e.start_ns() / 1e3, e.duration_ns() / 1e3
            tot, n = by_name.get(e.name(), (0.0, 0))
            by_name[e.name()] = (tot + dur, n + 1)
            spans.append((start, start + dur))
    busy_us, reach = 0.0, float("-inf")
    for start, end in sorted(spans):
        if end > reach:
            busy_us += end - max(start, reach)
            reach = end
    kernel_us = sum(t for t, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    return {"steps": steps, "wall_ms_per_step": wall_us / steps / 1e3,
            "device_busy_ms_per_step": busy_us / steps / 1e3,
            "device_busy_share": busy_us / wall_us,
            "kernel_ms_sum_per_step": kernel_us / steps / 1e3,
            "top_kernels": [{"name": k[:90], "ms_per_step": t / steps / 1e3,
                             "share_of_kernel_time": t / kernel_us,
                             "calls": n} for k, (t, n) in top]}, by_name


def phase_profile(torch, sim, steps=3):
    """Where a training step's device time goes: kernel time by name over
    a few steps of the CNN path (after its counts were read), and the
    device's busy share of the window's wall time.  First the same steps
    with cuDNN free to pick its default algorithms (what
    ``resolve_device`` set before F3's repair), then with the
    deterministic ones it pins now: the step time before and after, in
    one process (each after a warm-up step, where cuDNN chooses)."""
    state = {"stacked": sim._stacked}

    def step():
        x, y = sim._sample_minibatches(sim.t.batch_size)
        state["stacked"], _ = sim._client_step(state["stacked"], x, y)

    rows = {}
    try:
        for pinned in (False, True):
            torch.backends.cudnn.deterministic = pinned
            step()
            rows[pinned] = kernel_breakdown(torch, step, steps)
    finally:
        torch.backends.cudnn.deterministic = True
    (row, by_name), (before, _) = rows[True], rows[False]
    emit({"phase": "profile", **row,
          "quantize_ms_per_step": sum(
              t for k, (t, _) in by_name.items() if "qdq_f32" in k)
          / steps / 1e3,
          "cudnn_default": {k: before[k] for k in (
              "wall_ms_per_step", "device_busy_ms_per_step",
              "kernel_ms_sum_per_step", "top_kernels")},
          "pinned_over_default_wall": row["wall_ms_per_step"]
          / before["wall_ms_per_step"]})


# ------------------------------------------------------------------ K2 ----
def _flash_inputs(torch, b, s, h, kvh, d, dtype, seed):
    """q (B,S,H,d), k and v (B,S,KVH,d): the model's layout."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return tuple(torch.randn(b, s, n, d, generator=gen, device="cuda")
                 .to(dtype) for n in (h, kvh, kvh))


def _flash_plain(ref, q, k, v, **kw):
    return ref.attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                             v.transpose(1, 2), **kw).transpose(1, 2)


def phase_check_flash(torch, ops, ref):
    """K2 against its plain version on the card, on the same inputs."""
    import torch.nn.functional as F
    m = FLASH_MAIN
    cases = []
    for b, h, kvh, s, d in [(2, 4, 2, 256, 64), (1, 4, 4, 512, 32),
                            (1, 2, 1, 128, 128)]:      # the reference's sweep
        for dtype in ("float32", "bfloat16"):
            for causal, window in [(True, 0), (True, 64), (False, 0)]:
                cases.append(((b, s, h, kvh, d), dtype,
                              dict(causal=causal, window=window)))
    for dtype in ("float32", "bfloat16"):
        cases += [((1, 256, 2, 2, 32), dtype, dict(causal=True,
                                                   softcap=20.0)),
                  ((2, 100, 4, 2, 64), dtype, dict(causal=True)),
                  ((2, 100, 4, 2, 64), dtype, dict(causal=True, window=7)),
                  ((1, 96, 2, 1, 16 if dtype == "float32" else 32), dtype,
                   dict(causal=False, window=20))]
    # the bf16 kernel's tile edges (128 query rows a block, 64 keys a
    # tile, 64-column TMA boxes): ragged lengths at every head width
    # template (GQA 2:1), MQA 10:1, window edges inside a key tile (40,
    # 100) and on one (64, 128) with and without causality, softcap
    cases += [((1, s, 4, 2, d), "bfloat16", dict(causal=True))
              for s in FLASH_EDGE_LENGTHS for d in (32, 64, 128, 256)]
    cases += [((2, 129, 10, 1, 256), "bfloat16", dict(causal=True)),
              ((2, 300, 10, 1, 256), "bfloat16", dict(causal=False))]
    cases += [((2, 333, 4, 2, 128), "bfloat16", dict(causal=causal,
                                                      window=window))
              for window in (40, 64, 100, 128) for causal in (True, False)]
    cases += [((1, 257, 4, 2, d), "bfloat16", dict(causal=True,
                                                   softcap=30.0))
              for d in (64, 256)]
    # the head bank at the reference's size (reduced gemma3: 4 heads of
    # 64, window 64, 3 clients x 2 sequences of 32), and the serving
    # path's shapes at full width
    cases.append(((6, 32, 4, 4, 64), "float32", dict(causal=True,
                                                     window=64)))
    # recurrentgemma-2b's attention (one kv head for 10 query heads) with
    # 2560 tokens, so its window of 2048 binds on the last 512 rows
    mqa = FLASH_MQA
    cases.append(((mqa["b"], 2560, mqa["h"], mqa["kvh"], mqa["d"]),
                  "bfloat16", dict(causal=True, window=RGLRU_WINDOW)))
    # the training path's shapes (train_rglru): a local step's batch and
    # the head bank's and evaluations' one
    cases += [((b, TRAIN_RGLRU["seq"], mqa["h"], mqa["kvh"], mqa["d"]),
               "bfloat16", dict(causal=True, window=RGLRU_WINDOW))
              for b in train_batches(TRAIN_RGLRU)]
    for name, window in FLASH_LAYERS.items():
        cases.append(((m["b"], m["s"], m["h"], m["kvh"], m["d"]), "bfloat16",
                      dict(causal=True, window=window)))
    rows, worst = [], {"float32": 0.0, "bfloat16": 0.0}
    worst_rel = dict(worst)

    def compare(q, k, v, dtype, kw, **label):
        judge(ops.flash_attention(q, k, v, **kw),
              _flash_plain(ref, q, k, v, **kw), q.dtype, dtype, kw, **label)

    def judge(got, want, qdtype, dtype, kw, **label):
        torch.cuda.synchronize()
        diff = got.float() - want.float()
        err = float(diff.abs().max())
        rel = float(diff.norm() / want.float().norm())
        tol = FLASH_TOL[dtype]
        ok = bool(torch.allclose(got.float(), want.float(), rtol=tol,
                                 atol=tol)) and got.dtype == qdtype
        ok = ok and rel <= FLASH_REL_TOL[dtype]
        worst[dtype] = max(worst[dtype], err)
        worst_rel[dtype] = max(worst_rel[dtype], rel)
        rows.append({**label, "dtype": dtype, **kw, "max_abs_err": err,
                     "rel_err": rel, "ok": ok})

    for i, (shape, dtype, kw) in enumerate(cases):
        q, k, v = _flash_inputs(torch, *shape, getattr(torch, dtype), i)
        compare(q, k, v, dtype, kw, bshkd=list(shape))
    n_main = len(FLASH_LAYERS)
    main_rows, mqa_row = rows[-n_main:], rows[-n_main - 3]
    train_rows = rows[-n_main - 2:-n_main]
    # q, k, v as slices of one fused bf16 projection, read in place
    # through the tensor maps' strides
    for d in (64, 256):
        gen = torch.Generator(device="cuda").manual_seed(d)
        qkv = torch.randn(2, 129, 8, d, generator=gen, device="cuda").to(
            torch.bfloat16)
        q, k, v = qkv[:, :, :4], qkv[:, :, 4:6], qkv[:, :, 6:]
        for kw in (dict(causal=True), dict(causal=False, window=50)):
            compare(q, k, v, "bfloat16", kw, bshkd=[2, 129, 4, 2, d],
                    fused_slices=True)
    # the zoo slice: head width 192 (MLA's 128 + 64, the D = 256 template
    # with TMA zero-filling the columns past 192) in both dtypes and at the
    # bf16 tiles' edges; olmoe's MHA at head width 128 (the head bank and
    # train_olmoe's local step and bank) and qwen2-vl's 7:1 GQA (its
    # training shapes)
    o, qw = FLASH_OLMOE, FLASH_QWEN
    zoo = [((1, s, 4, 4, 192), "bfloat16", dict(causal=True))
           for s in FLASH_EDGE_LENGTHS]
    zoo += [((2, 300, 4, 2, 192), "bfloat16", dict(causal=False,
                                                    window=100)),
            ((1, 257, 4, 4, 192), "float32", dict(causal=True)),
            ((2, 100, 4, 2, 192), "float32", dict(causal=False))]
    zoo += [((b, o["s"], o["h"], o["kvh"], o["d"]), "bfloat16",
             dict(causal=True)) for b in (o["b"], *train_batches(TRAIN_ZOO))]
    zoo += [((b, qw["s"], qw["h"], qw["kvh"], qw["d"]), "bfloat16",
             dict(causal=True)) for b in train_batches(TRAIN_ZOO)]
    n_rows = len(rows)
    for i, (shape, dtype, kw) in enumerate(zoo):
        q, k, v = _flash_inputs(torch, *shape, getattr(torch, dtype),
                                1000 + i)
        compare(q, k, v, dtype, kw, bshkd=list(shape))
    zoo_rows = rows[n_rows:]
    # MLA's call: q and k of 192 columns, v of 128 zero-padded to 192 for
    # the kernel, the output sliced back, against the plain version on
    # the unpadded v (which takes a narrower v); deepseek's serving shape
    # compared a batch element at a time (the plain version's float32
    # logits of the whole batch are 12.9 GB)
    ml = FLASH_MLA
    for b, s, h, dtype in ((2, 129, 4, "float32"), (2, 129, 4, "bfloat16"),
                           (ml["b"], ml["s"], ml["h"], "bfloat16")):
        q, k, v = _flash_inputs(torch, b, s, h, h, ml["d"],
                                getattr(torch, dtype), 2000 + s)
        v = v[..., :ml["dv"]].contiguous()
        got = ops.flash_attention(q, k, F.pad(v, (0, ml["d"] - ml["dv"])),
                                  causal=True)[..., :ml["dv"]]
        want = torch.cat([_flash_plain(ref, q[i:i + 1], k[i:i + 1],
                                       v[i:i + 1], causal=True)
                          for i in range(b)])
        judge(got, want, q.dtype, dtype, dict(causal=True),
              bshkd=[b, s, h, h, ml["d"]], dv=ml["dv"], padded_v=True)
    mla_rows = rows[-3:]
    del q, k, v, got, want
    # seamless-m4t-medium: 16 heads of 64 (MHA) in the encoder's
    # non-causal self-attention over 1024 frames and the decoder's causal
    # one over 2048 tokens, bf16, at the batches its paths give them (the
    # head bank's 6 sequences, the decode cache's encode of 4, the
    # training phase's local step of 1 and its bank's 2), and
    # reference_encdec's float32 shapes
    se, sd = FLASH_SEAMLESS_ENCODER, FLASH_SEAMLESS
    seamless = [((b, se["s"], se["h"], se["kvh"], se["d"]), "bfloat16",
                 dict(causal=False)) for b in (se["b"], 4, 2, 1)]
    seamless += [((b, sd["s"], sd["h"], sd["kvh"], sd["d"]), "bfloat16",
                  dict(causal=True)) for b in (sd["b"], 2, 1)]
    seamless += [((2, 32, 4, 4, 64), "float32", dict(causal=False)),
                 ((2, 64, 4, 4, 64), "float32", dict(causal=True))]
    n_rows = len(rows)
    for i, (shape, dtype, kw) in enumerate(seamless):
        q, k, v = _flash_inputs(torch, *shape, getattr(torch, dtype),
                                3000 + i)
        compare(q, k, v, dtype, kw, bshkd=list(shape))
    seamless_rows = rows[n_rows:]
    del q, k, v
    # backward: a recompute through the port's dense path, against
    # autograd of the plain version
    q, k, v = _flash_inputs(torch, 1, 64, 4, 2, 32, torch.float32, 99)
    w = torch.randn_like(q)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    (ops.flash_attention(*leaves, causal=True, window=16) * w).sum().backward()
    plain = [t.clone().requires_grad_() for t in (q, k, v)]
    (_flash_plain(ref, *plain, causal=True, window=16) * w).sum().backward()
    grad_err = max(float((a.grad - b.grad).abs().max())
                   for a, b in zip(leaves, plain))
    grad_ok = all(torch.allclose(a.grad, b.grad, rtol=1e-4, atol=1e-4)
                  for a, b in zip(leaves, plain))
    # the zoo's backwards: MLA's padded call (float32, 1e-4 as above) and
    # qwen2-vl's 7:1 GQA at its training shape in bf16 (both sides round
    # float32 gradients to bf16 once: K2's bf16 tolerance)
    zoo_grads = {}
    q, k, v = _flash_inputs(torch, 1, 256, 4, 4, ml["d"], torch.float32, 98)
    v = v[..., :ml["dv"]].contiguous()
    w = torch.randn(1, 256, 4, ml["dv"], device="cuda")
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    (ops.flash_attention(leaves[0], leaves[1],
                         F.pad(leaves[2], (0, ml["d"] - ml["dv"])),
                         causal=True)[..., :ml["dv"]] * w).sum().backward()
    plain = [t.clone().requires_grad_() for t in (q, k, v)]
    (_flash_plain(ref, *plain, causal=True) * w).sum().backward()
    zoo_grads["mla_padded_float32"] = (
        max(float((a.grad - b.grad).abs().max())
            for a, b in zip(leaves, plain)),
        all(torch.allclose(a.grad, b.grad, rtol=1e-4, atol=1e-4)
            for a, b in zip(leaves, plain)))
    q, k, v = _flash_inputs(torch, 1, qw["s"], qw["h"], qw["kvh"], qw["d"],
                            torch.bfloat16, 97)
    w = torch.randn(q.shape, device="cuda").to(torch.bfloat16)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    (ops.flash_attention(*leaves, causal=True) * w).float().sum().backward()
    plain = [t.clone().requires_grad_() for t in (q, k, v)]
    (_flash_plain(ref, *plain, causal=True) * w).float().sum().backward()
    tol = FLASH_TOL["bfloat16"]
    zoo_grads["qwen_gqa_bfloat16"] = (
        max(float((a.grad.float() - b.grad.float()).abs().max())
            for a, b in zip(leaves, plain)),
        all(torch.allclose(a.grad.float(), b.grad.float(), rtol=tol,
                           atol=tol) for a, b in zip(leaves, plain)))
    # seamless's decoder at its serving shape (6, 2048, 16 heads of 64),
    # causal, bf16: K2's backward (the dense recompute) against autograd
    # of the plain version
    q, k, v = _flash_inputs(torch, sd["b"], sd["s"], sd["h"], sd["kvh"],
                            sd["d"], torch.bfloat16, 96)
    w = torch.randn(q.shape, device="cuda").to(torch.bfloat16)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    (ops.flash_attention(*leaves, causal=True) * w).float().sum().backward()
    plain = [t.clone().requires_grad_() for t in (q, k, v)]
    (_flash_plain(ref, *plain, causal=True) * w).float().sum().backward()
    zoo_grads["seamless_decoder_bfloat16"] = (
        max(float((a.grad.float() - b.grad.float()).abs().max())
            for a, b in zip(leaves, plain)),
        all(torch.allclose(a.grad.float(), b.grad.float(), rtol=tol,
                           atol=tol) for a, b in zip(leaves, plain)))
    del leaves, plain, q, k, v, w
    bad = [r for r in rows if not r["ok"]]
    emit({"phase": "check_flash", "kernel": "flash_attention",
          "cases": len(rows), "tolerance": FLASH_TOL,
          "rel_tolerance": FLASH_REL_TOL, "max_abs_err": worst,
          "max_rel_err": worst_rel, "mismatches": bad,
          "main_shapes": main_rows, "mqa_window_binds": mqa_row,
          "train_shapes": train_rows, "zoo_shapes": zoo_rows,
          "mla_padded_v": mla_rows, "seamless_shapes": seamless_rows,
          "backward_max_abs_err": grad_err, "backward_ok": grad_ok,
          "zoo_backward": {name: {"max_abs_err": e, "ok": ok}
                           for name, (e, ok) in zoo_grads.items()}})
    assert not bad and grad_ok, "K2 disagrees with its plain version"
    assert all(ok for _, ok in zoo_grads.values()), zoo_grads
    return max(worst.values())


def flash_work(b, s, h, kvh, d, window, bytes_per_el=2, dv=None):
    """Unmasked (q, k) pairs of causal attention with this window, the
    flops they need (2 d for QK^T and 2 dv for PV each; dv = d but for
    MLA's narrower v) and the bytes the function must move (q, k, v read
    once, o written once)."""
    dv = d if dv is None else dv
    pairs = sum(min(q + 1, window) if window else q + 1 for q in range(s))
    flops = 2 * (d + dv) * pairs * b * h
    nbytes = (b * s * h * (d + dv) + b * s * kvh * (d + dv)) * bytes_per_el
    return pairs, flops, nbytes


def phase_time_flash(torch, ops, ref, m=FLASH_MAIN, layers=FLASH_LAYERS,
                     arch="gemma3-12b"):
    """K2 at a serving path's shapes: the kernel, its plain version, its
    bound, and one PyTorch call that computes the same function
    (scaled_dot_product_attention with enable_gqa; a boolean band mask
    for a sliding window that binds), with the name of the kernel it
    ran.  None of the models has an attention softcap, so the functions
    are the same; the port never calls that function.  With ``dv`` in
    ``m`` (MLA) v has dv columns: the kernel is timed on v zero-padded to
    d, as the model calls it, the plain version and the library call on
    the unpadded v, and the bound counts the function's own bytes and
    flops."""
    import torch.nn.functional as F
    q, k, v = _flash_inputs(torch, m["b"], m["s"], m["h"], m["kvh"], m["d"],
                            torch.bfloat16, 7)
    dv = m.get("dv", m["d"])
    v = v[..., :dv].contiguous()
    vk = F.pad(v, (0, m["d"] - dv)) if dv < m["d"] else v
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
    pos = torch.arange(m["s"], device="cuda")
    out = {}
    for name, window in layers.items():
        kernel_ms = event_ms(torch, lambda: ops.flash_attention(
            q, k, vk, causal=True, window=window), iters=20)
        plain_ms = event_ms(torch, lambda: _flash_plain(
            ref, q, k, v, causal=True, window=window), iters=5, warmup=1)
        if window and window < m["s"]:
            band = ((pos[None, :] <= pos[:, None])
                    & (pos[None, :] > pos[:, None] - window))
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qh, kh, vh, attn_mask=band, enable_gqa=True)
        else:
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qh, kh, vh, is_causal=True, enable_gqa=True)
        library_ms = event_ms(torch, lib, iters=20)
        _, lib_kernels = kernel_breakdown(torch, lib, 1)
        lib_err = float((lib().transpose(1, 2).float() - ops.flash_attention(
            q, k, vk, causal=True, window=window)[..., :dv].float())
            .abs().max())
        pairs, flops, nbytes = flash_work(m["b"], m["s"], m["h"], m["kvh"],
                                          m["d"], window, dv=dv)
        # the same inputs without any mask: every key tile of every row,
        # no boundary tiles and no causal imbalance across blocks, so the
        # rate of the kernel's steady loop alone
        full_ms = event_ms(torch, lambda: ops.flash_attention(
            q, k, vk, causal=False, window=0), iters=10)
        full_flops = 2 * (m["d"] + dv) * m["s"] * m["s"] * m["b"] * m["h"]
        flop_ms = flops / BF16_FLOPS * 1e3
        byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
        row = {"phase": "time_flash", "kernel": "flash_attention",
               "arch": arch, "layer": name, "window": window, "bshkd": [
                   m["b"], m["s"], m["h"], m["kvh"], m["d"]], "dv": dv,
               "library_kernels": sorted(k[:90] for k in lib_kernels),
               "dtype": "bfloat16", "kernel_ms": kernel_ms,
               "plain_ms": plain_ms, "library_ms": library_ms,
               "bound_ms": max(flop_ms, byte_ms),
               "bound_by": "operations" if flop_ms >= byte_ms else "bytes",
               "flop_bound_ms": flop_ms, "byte_bound_ms": byte_ms,
               "pairs_per_head": pairs, "flops": flops, "bytes": nbytes,
               "rate_source": "NVIDIA H100 SXM data sheet: 989 TFLOP/s "
                              "dense bf16, 3.35 TB/s HBM3",
               "kernel_TFLOPs": flops / kernel_ms / 1e9,
               "bound_fraction": max(flop_ms, byte_ms) / kernel_ms,
               "unmasked_kernel_ms": full_ms,
               "unmasked_TFLOPs": full_flops / full_ms / 1e9,
               "library_vs_kernel_max_abs_diff": lib_err}
        emit(row)
        out[name] = row
    return out


def phase_check_flash_backward(torch, ops):
    """F1: K2's backward past DENSE_MAX_SEQ (4096) tokens recomputes by
    query blocks of Q_CHUNK (1024) rows.  One gemma3-width layer (16 query
    heads over 8 kv heads of 256) at S = 8192, bf16, global and window
    1024: the peak allocation of the blocked recompute and of the dense
    one (forced by raising the threshold; it fits the card at this size),
    and the gradients' difference.  Fails on an error above K2's bf16
    tolerance, a relative error above FLASH_BWD_REL_TOL, or a blocked peak
    at or above one float32 dense logits tensor (4.3 GB)."""
    from repro_torch.models import attention
    m = FLASH_BWD
    q, k, v = _flash_inputs(torch, m["b"], m["s"], m["h"], m["kvh"], m["d"],
                            torch.bfloat16, 11)
    gen = torch.Generator(device="cuda").manual_seed(12)
    g = torch.randn(q.shape, generator=gen, device="cuda").to(q.dtype)
    tol = FLASH_TOL["bfloat16"]
    rows = []

    def grads(window):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        ops.flash_attention(*leaves, causal=True, window=window).backward(g)
        torch.cuda.synchronize()
        return ([t.grad for t in leaves], torch.cuda.max_memory_allocated(),
                time.perf_counter() - t0)

    for window in FLASH_BWD_WINDOWS:
        assert m["s"] > attention.DENSE_MAX_SEQ
        blocked, blocked_peak, blocked_s = grads(window)
        dense_max = attention.DENSE_MAX_SEQ
        attention.DENSE_MAX_SEQ = m["s"]
        try:
            dense, dense_peak, dense_s = grads(window)
        finally:
            attention.DENSE_MAX_SEQ = dense_max
        errs, rels, ok = [], [], True
        for a, b in zip(blocked, dense):
            diff = a.float() - b.float()
            errs.append(float(diff.abs().max()))
            rels.append(float(diff.norm() / b.float().norm()))
            ok = ok and bool(torch.isfinite(a).all()) and bool(
                torch.allclose(a.float(), b.float(), rtol=tol, atol=tol))
        ok = (ok and blocked_peak < DENSE_LOGITS_BYTES
              and max(rels) <= FLASH_BWD_REL_TOL)
        rows.append({"window": window, "blocked_peak_GB": blocked_peak / 1e9,
                     "dense_peak_GB": dense_peak / 1e9,
                     "blocked_wall_s": blocked_s, "dense_wall_s": dense_s,
                     "grad_max_abs_err": dict(zip("qkv", errs)),
                     "grad_rel_err": dict(zip("qkv", rels)), "ok": ok})
        del blocked, dense
    emit({"phase": "check_flash_backward", "kernel": "flash_attention",
          "shape": "q (1,8192,16,256), k/v (1,8192,8,256) bf16, causal",
          "dense_max_seq": attention.DENSE_MAX_SEQ,
          "q_chunk": attention.Q_CHUNK, "tolerance": tol,
          "rel_tolerance": FLASH_BWD_REL_TOL,
          "peak_limit_GB": DENSE_LOGITS_BYTES / 1e9, "layers": rows})
    assert all(r["ok"] for r in rows), "K2's blocked backward failed"
    return rows


# ------------------------------------------------------------- serving ----
def phase_reference_serve(np):
    """serve() at gemma3-12b.reduced(num_layers=12) (lead, scan and tail
    stages, window 64) on the card against the same call on the CPU, with
    the same weights and seed.  The head bank runs on 160-token sequences
    so the window binds and the last key tile is ragged.  Tolerances:
    float32 summation order (cuBLAS and K2 against the CPU's kernels),
    1e-4 on the head bank and the logits, as the CPU parity tests allow
    against the JAX package; the tokens must be equal."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch.serve import serve
    from repro_torch.models.registry import build_model
    from repro_torch.telemetry import MetricLogger
    from repro_torch.utils.prng import make_generator
    from repro_torch.utils.tree import tree_map
    cfg = get_arch("gemma3-12b").reduced(num_layers=12)
    params = build_model(cfg).init(make_generator(0, "cpu"))
    kw = dict(batch=4, steps=16, clients=3, prompt_len=16, seed=0,
              bank_seq=160, log=MetricLogger("reference_serve", sys.stderr))
    card = serve(cfg, params=tree_map(lambda t: t.cuda(), params),
                 device="cuda", **kw)
    cpu = serve(cfg, params=params, device="cpu", **kw)
    diffs = {}
    for name in ("head_bank", "logits", "bank_losses"):
        a = getattr(card, name).cpu().numpy()
        b = getattr(cpu, name).numpy()
        assert np.isfinite(a).all(), name
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4, err_msg=name)
        diffs[name] = float(np.abs(a - b).max())
    same_tokens = card.generated.cpu().tolist() == cpu.generated.tolist()
    emit({"phase": "reference_serve", "config": cfg.name,
          "stages": ["lead", "scan", "tail"], "bank_seq": 160,
          "cuda_vs_cpu_max_abs_diff": diffs, "tol": 1e-4,
          "same_tokens": same_tokens,
          "same_profiles": card.profiles.tolist() == cpu.profiles.tolist()})
    assert same_tokens, "generated tokens differ between card and CPU"


def phase_serve(torch, kernels):
    """The LM path at gemma3-12b's full width (d_model 3840, 16/8 heads of
    256, d_ff 15360, vocab 262144, bf16, window 1024), cut to 12 layers:
    lead (2), scan (6) and tail (4) stages, layers 5 and 11 global.  The
    reference's serving defaults (batch 4, 3 clients, prompt 16, 16
    steps) with a head bank over 2048-token sequences, so the window
    binds."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch.serve import personalized_logits, serve
    from repro_torch.models.registry import build_model
    from repro_torch.telemetry import MetricLogger
    from repro_torch.utils.prng import make_generator
    from repro_torch.utils.tree import tree_leaves
    cfg = dataclasses.replace(get_arch("gemma3-12b"), num_layers=12)
    model = build_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    params, init_s = sync_time(
        torch, lambda: model.init(make_generator(0, "cuda")))
    n_params = sum(t.numel() for t in tree_leaves(params))
    kw = dict(batch=4, steps=16, clients=3, prompt_len=16, seed=0,
              bank_seq=2048)

    reset_counts(kernels)                  # count this path's run alone
    res, wall = sync_time(torch, lambda: serve(
        cfg, params=params, device="cuda",
        log=MetricLogger("serve", sys.stderr), **kw))
    counts = read_counts(kernels)
    peak = torch.cuda.max_memory_allocated()

    # the path implies one K2 launch per attention layer: the head bank's
    # trunk forward runs all clients' sequences at once, and decoding is
    # dense tensor code over the cache
    expected = attention_layers(cfg)
    finite = bool(torch.isfinite(res.logits).all()
                  and torch.isfinite(res.bank_losses).all()
                  and torch.isfinite(res.head_bank.float()).all())
    shapes_ok = (tuple(res.generated.shape) == (kw["batch"], kw["steps"])
                 and tuple(res.logits.shape) == (kw["batch"], kw["steps"],
                                                 cfg.padded_vocab)
                 and tuple(res.head_bank.shape) == (
                     kw["clients"], cfg.d_model, cfg.padded_vocab))
    tokens_ok = bool(((res.generated >= 0)
                      & (res.generated < cfg.vocab_size)).all())
    emit({"phase": "serve", "config": {
              "arch": cfg.name, "num_layers": cfg.num_layers,
              "layer_kinds": list(cfg.layer_kinds()),
              "d_model": cfg.d_model, "heads": cfg.num_heads,
              "kv_heads": cfg.num_kv_heads, "head_dim": cfg.head_dim,
              "d_ff": cfg.d_ff, "vocab": cfg.padded_vocab,
              "window": cfg.sliding_window, "dtype": cfg.dtype, **kw},
          "params": n_params, "init_s": init_s, "serve_wall_s": wall,
          "head_bank_s": res.bank_seconds, "decode_s": res.decode_seconds,
          "decode_tokens": res.tokens, "decode_tok_per_s": res.tok_per_s,
          "bank_losses": res.bank_losses.cpu().tolist(),
          "profiles": res.profiles.tolist(),
          "generated": res.generated.cpu().tolist(),
          "peak_mem_GB": peak / 1e9, "launches": counts,
          "flash_launches_expected": expected, "finite": finite,
          "shapes_ok": shapes_ok, "tokens_in_vocab": tokens_ok})
    assert finite, "non-finite logits or losses"
    assert shapes_ok and tokens_ok, "serve output has the wrong shape"
    assert counts["flash_attention"] == expected > 0, (counts, expected)
    assert (counts["quantize"] == counts["mlstm_chunk"]
            == counts["rglru_scan"] == 0), counts

    # where the device time goes (after the counts): the head bank's one
    # trunk forward, and one decode step with its per-request heads
    toks = torch.randint(0, cfg.vocab_size, (6, 2048), device="cuda")

    def forward():
        with torch.no_grad():
            model.apply(params, {"tokens": toks})

    row, by_name = kernel_breakdown(torch, forward, 2)
    flash_ms = sum(t for k, (t, _) in by_name.items()
                   if "flash_fwd" in k) / 2 / 1e3
    emit({"phase": "serve_profile", "what": "one trunk forward, 6 x 2048 "
          "tokens, 12 layers, bf16", **row,
          "flash_ms_per_step": flash_ms,
          "flash_share_of_kernel_time": flash_ms
          / row["kernel_ms_sum_per_step"]
          if row["kernel_ms_sum_per_step"] else None})

    cache = model.init_cache(kw["batch"], kw["prompt_len"] + kw["steps"],
                             dtype=torch.float32, device="cuda")
    bank32 = res.head_bank.to(torch.float32)
    tok = res.generated[:, :1]

    def decode():
        with torch.no_grad():
            h, _ = model.decode_step(params, tok, cache, kw["prompt_len"],
                                     return_hidden=True)
            personalized_logits(h.to(torch.float32), bank32, res.profiles)

    decode()                               # warm-up outside the profile
    row, _ = kernel_breakdown(torch, decode, 5)
    emit({"phase": "serve_profile", "what": "one decode step, batch 4, "
          "12 layers, per-request float32 heads", **row})
    return counts["flash_attention"]


# ------------------------------------------------------------------ K3 ----
def _mlstm_inputs(torch, b, s, h, dh, dtype, seed):
    """q, k, v (B,S,H,dh) in ``dtype`` and float32 gates (B,S,H), the
    model's layout, drawn as the reference's sweep draws them
    (tests/test_kernels.py:94-99: k over sqrt(dh), lf a log sigmoid)."""
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn(b, s, h, dh, generator=gen, device="cuda")
               for _ in range(3))
    li = torch.randn(b, s, h, generator=gen, device="cuda")
    lf = F.logsigmoid(torch.randn(b, s, h, generator=gen, device="cuda"))
    return q.to(dtype), (k / math.sqrt(dh)).to(dtype), v.to(dtype), li, lf


def _mlstm_plain(ref, q, k, v, li, lf):
    return ref.mlstm_chunkwise(q, k, v, li, lf, chunk=ref.KERNEL_CHUNK)[0]


def _mlstm_plain_chunked(ref, q, k, v, li, lf):
    """The plain version at its chunk of 128 on zero rows padded to a
    multiple of it, cut back to S (rows after t do not change h_t).  At a
    ragged S the plain version itself takes one quadratic chunk, whose
    float32 cumsum of the forget gates over the whole sequence drifts by
    more than a bf16 step at S = 2049 against the float64 recurrent
    oracle (``check_mlstm`` reads that witness on the card, and
    tests/test_torch_mlstm_three_pass.py on the CPU)."""
    import torch.nn.functional as F
    s = q.shape[1]
    pad = -s % ref.KERNEL_CHUNK
    padded = [F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
              for t in (q, k, v, li, lf)]
    return _mlstm_plain(ref, *padded)[:, :s]


def phase_check_mlstm(torch, ops, ref):
    """K3 against its plain version on the card, on the same inputs."""
    m = MLSTM_MAIN
    cases = []
    for b, h, s, dh in [(2, 2, 128, 32), (1, 4, 256, 64), (1, 1, 64, 16)]:
        for dtype in ("float32", "bfloat16"):       # the reference's sweep
            cases.append(((b, s, h, dh), dtype))
    cases += [((6, 160, 2, 256), "float32"),         # reduced model's heads
              ((2, 333, 2, 64), "float32"),          # ragged: 5 chunks + 13
              ((2, 333, 2, 64), "bfloat16"),
              ((1, 1, 2, 48), "float32")]            # one position
    # the bf16 kernel's tile edges, against the chunked plain version
    edges = [((1, s, 2, dh), "bfloat16") for s in MLSTM_EDGE_LENGTHS
             for dh in MLSTM_EDGE_WIDTHS]
    # the training path's shapes (train_xlstm, train_xlstm_2048): a local
    # step's batch and the head bank's and evaluations' one, bf16
    train = [((b, kw["seq"], m["h"], m["dh"]), "bfloat16")
             for kw in (TRAIN_XLSTM, TRAIN_XLSTM_CONTEXT)
             for b in train_batches(kw)]
    cases += train
    for dtype in ("float32", "bfloat16"):            # the serving shape
        cases.append(((m["b"], m["s"], m["h"], m["dh"]), dtype))
    rows, worst = [], {"float32": 0.0, "bfloat16": 0.0}
    worst_ratio = dict(worst)

    def tol_ratio(got, want, tol):
        """The worst |got - want| / (atol + rtol |want|): <= 1 passes."""
        want = want.double()
        return float(((got.double() - want).abs()
                      / (tol["atol"] + tol["rtol"] * want.abs())).max())

    witness = []

    def compare(x, dtype, plain, **label):
        got = ops.mlstm_chunk(*x)
        want = plain(ref, *x)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        tol = MLSTM_TOL[dtype]
        ratio = tol_ratio(got, want, tol)
        ok = (ratio <= 1.0 and got.dtype == x[0].dtype
              and got.shape == x[0].shape)
        worst[dtype] = max(worst[dtype], err)
        worst_ratio[dtype] = max(worst_ratio[dtype], ratio)
        rows.append({**label, "dtype": dtype, "max_abs_err": err,
                     "tol_ratio": ratio,
                     "max_abs_out": float(want.float().abs().max()),
                     "ok": ok})

    for i, (shape, dtype) in enumerate(edges):
        x = _mlstm_inputs(torch, *shape, getattr(torch, dtype), 1000 + i)
        compare(x, dtype, _mlstm_plain_chunked, bshd=list(shape),
                tile_edge=True)
        if shape[1] == max(MLSTM_EDGE_LENGTHS):
            # the float64 recurrent oracle on the same inputs: the kernel
            # and the padded plain version within MLSTM_TOL of it, the
            # unpadded plain version (its one quadratic chunk) as read
            tr = [t.transpose(1, 2).double() for t in x]
            oracle = ref.mlstm_recurrent_ref(*tr, dtype=torch.float64)
            oracle = oracle.transpose(1, 2)
            tol = MLSTM_TOL[dtype]
            witness.append({"bshd": list(shape), **{
                name: tol_ratio(fn(), oracle, tol) for name, fn in (
                    ("kernel", lambda: ops.mlstm_chunk(*x)),
                    ("plain_padded", lambda: _mlstm_plain_chunked(ref, *x)),
                    ("plain_one_chunk", lambda: _mlstm_plain(ref, *x)))}})
            del tr, oracle
        del x
    # bf16 q, k, v as slices of one fused (B,S,H,3 dh) buffer, read in
    # place by the tensor maps, over two state chunks
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda").manual_seed(5)
    qkv = torch.randn(2, 300, 2, 3 * 64, generator=gen, device="cuda")
    qkv[..., 64:128] /= 8.0
    qkv = qkv.to(torch.bfloat16)
    gates = torch.randn(2, 300, 4, generator=gen, device="cuda")
    compare((qkv[..., :64], qkv[..., 64:128], qkv[..., 128:],
             gates[..., :2], F.logsigmoid(gates[..., 2:])), "bfloat16",
            _mlstm_plain_chunked, bshd=[2, 300, 2, 64], fused_slices=True)
    for i, (shape, dtype) in enumerate(cases):
        x = _mlstm_inputs(torch, *shape, getattr(torch, dtype), i)
        compare(x, dtype, _mlstm_plain, bshd=list(shape))
        del x
    # backward: autograd of the plain version, as the reference's VJP
    x = _mlstm_inputs(torch, 1, 64, 2, 16, torch.float32, 99)
    w = torch.randn_like(x[0])
    leaves = [t.clone().requires_grad_() for t in x]
    (ops.mlstm_chunk(*leaves) * w).sum().backward()
    plain = [t.clone().requires_grad_() for t in x]
    (_mlstm_plain(ref, *plain) * w).sum().backward()
    grad_err = max(float((a.grad - b.grad).abs().max())
                   for a, b in zip(leaves, plain))
    grad_ok = all(torch.allclose(a.grad, b.grad, **MLSTM_TOL["float32"])
                  for a, b in zip(leaves, plain))
    bad = [r for r in rows if not r["ok"]]
    witness_ok = all(w["kernel"] <= 1.0 and w["plain_padded"] <= 1.0
                     for w in witness)
    emit({"phase": "check_mlstm", "kernel": "mlstm_chunk",
          "cases": len(rows), "tolerance": MLSTM_TOL,
          "max_abs_err": worst, "max_tol_ratio": worst_ratio,
          "tile_edge_cases": len(edges), "mismatches": bad,
          "float64_witness_tol_ratio": witness, "witness_ok": witness_ok,
          "main_shapes": rows[-2:],
          "train_shapes": rows[-2 - len(train):-2],
          "backward_max_abs_err": grad_err,
          "backward_ok": grad_ok})
    assert not bad and grad_ok and witness_ok, \
        "K3 disagrees with its plain version"
    return max(worst.values())


def mlstm_work(b, s, h, dh, chunk=128, bytes_per_el=2):
    """What the function needs at the reference's chunk of 128: per (b, h,
    chunk of l rows), 2 dh l(l+1)/2 flops each for QK^T and (S.D)V (D is
    lower-triangular) and 2 * 2 l dh^2 for QC and K^T V; no D K product
    (q . n_intra is a row sum of QK^T.D).  The bytes: q, k, v read once
    and h written once in their dtype, li and lf read once in float32."""
    lens = [min(chunk, s - c) for c in range(0, s, chunk)]
    flops = b * h * sum(2 * dh * l * (l + 1) + 4 * l * dh * dh for l in lens)
    nbytes = 4 * b * s * h * dh * bytes_per_el + 2 * b * s * h * 4
    return flops, nbytes


def mlstm_state_bytes(b, s, h, dh, chunk):
    """The bf16 kernel's extra traffic: the boundary states (C as bf16 hi
    and lo planes and n likewise, at each boundary of a state chunk but
    the last), written once and read once."""
    nb = -(-s // chunk) - 1
    return 2 * b * h * nb * 2 * (dh * dh + dh) * 2


def phase_time_mlstm(torch, ops, ref, kernel):
    """K3 at the serving shape in bf16 (and float32 for reference): the
    kernel, its plain version and its bound; in bf16 also each of its
    CUDA kernels alone (CUDA events over repeated launches on one set of
    workspaces) and the floor its design adds, the states' traffic at
    the HBM rate.  No single PyTorch call computes the
    mLSTM, so there is no library time."""
    m = MLSTM_MAIN
    out = {}
    for dtype, nbytes_el in (("bfloat16", 2), ("float32", 4)):
        x = _mlstm_inputs(torch, m["b"], m["s"], m["h"], m["dh"],
                          getattr(torch, dtype), 7)
        kernel_ms = event_ms(torch, lambda: ops.mlstm_chunk(*x), iters=20,
                             warmup=3)
        plain_ms = event_ms(torch, lambda: _mlstm_plain(ref, *x), iters=5,
                            warmup=1)
        flops, nbytes = mlstm_work(m["b"], m["s"], m["h"], m["dh"],
                                   bytes_per_el=nbytes_el)
        flop_ms = flops / BF16_FLOPS * 1e3
        byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
        row = {"phase": "time_mlstm", "kernel": "mlstm_chunk",
               "bshd": [m["b"], m["s"], m["h"], m["dh"]], "dtype": dtype,
               "kernel_ms": kernel_ms, "plain_ms": plain_ms,
               "bound_ms": max(flop_ms, byte_ms),
               "bound_by": "operations" if flop_ms >= byte_ms else "bytes",
               "flop_bound_ms": flop_ms, "byte_bound_ms": byte_ms,
               "fp32_fma_bound_ms": flops / FP32_FLOPS * 1e3,
               "flops": flops, "bytes": nbytes,
               "rate_source": "NVIDIA H100 SXM data sheet: 989 TFLOP/s "
                              "dense bf16, 67 TFLOP/s float32, 3.35 TB/s "
                              "HBM3",
               "kernel_TFLOPs": flops / kernel_ms / 1e9,
               "library_ms": None,
               "library_note": "no single PyTorch call computes the "
                               "chunkwise mLSTM"}
        if dtype == "bfloat16":
            passes = kernel.bf16_passes(*x)
            for launch in passes:            # fill the workspaces in order
                launch()
            pass_ms = {n: event_ms(torch, f, iters=20, warmup=2)
                       for n, f in zip(kernel.BF16_PASSES, passes)}
            state_bytes = mlstm_state_bytes(m["b"], m["s"], m["h"], m["dh"],
                                            kernel.STATE_CHUNK)
            floor_ms = state_bytes / HBM_BYTES_PER_S * 1e3
            row.update(
                cuda_kernels_per_call=len(passes), pass_ms=pass_ms,
                pass_share={n: t / sum(pass_ms.values())
                            for n, t in pass_ms.items()},
                state_bytes=state_bytes,
                state_floor_ms=floor_ms,
                design_floor_ms=row["bound_ms"] + floor_ms,
                design_floor_fraction=(row["bound_ms"] + floor_ms)
                / kernel_ms)
            del passes
        emit(row)
        out[dtype] = row
        del x
    return out


# --------------------------------------------------------- xLSTM serving --
def phase_reference_serve_xlstm(torch, np, kernels):
    """serve() at xlstm-350m.reduced(num_layers=6) (lead, scan and tail
    stages; mLSTM heads of 256) on the card against the same call on the
    CPU, with the same weights and seed.  The head bank runs on
    160-token sequences: K3 takes two chunks of 64 and a ragged one of
    32, the CPU's plain version one quadratic chunk.  Tolerances as for
    gemma3: 1e-4 on the head bank, the losses and the logits; the tokens
    must be equal."""
    from repro_torch.configs.base import MLSTM
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch.serve import serve
    from repro_torch.models.registry import build_model
    from repro_torch.telemetry import MetricLogger
    from repro_torch.utils.prng import make_generator
    from repro_torch.utils.tree import tree_map
    cfg = get_arch("xlstm-350m").reduced(num_layers=6)
    params = build_model(cfg).init(make_generator(0, "cpu"))
    kw = dict(batch=4, steps=16, clients=3, prompt_len=16, seed=0,
              bank_seq=160,
              log=MetricLogger("reference_serve_xlstm", sys.stderr))
    before = kernels["mlstm_chunk"].launches
    card = serve(cfg, params=tree_map(lambda t: t.cuda(), params),
                 device="cuda", **kw)
    card_launches = kernels["mlstm_chunk"].launches - before
    cpu = serve(cfg, params=params, device="cpu", **kw)
    diffs = {}
    for name in ("head_bank", "logits", "bank_losses"):
        a = getattr(card, name).cpu().numpy()
        b = getattr(cpu, name).numpy()
        assert np.isfinite(a).all(), name
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4, err_msg=name)
        diffs[name] = float(np.abs(a - b).max())
    same_tokens = card.generated.cpu().tolist() == cpu.generated.tolist()
    n_mlstm = sum(k == MLSTM for k in cfg.layer_kinds())
    emit({"phase": "reference_serve_xlstm", "config": cfg.name,
          "layer_kinds": list(cfg.layer_kinds()),
          "stages": ["lead", "scan", "tail"], "bank_seq": 160,
          "cuda_vs_cpu_max_abs_diff": diffs, "tol": 1e-4,
          "card_k3_launches": card_launches, "same_tokens": same_tokens,
          "same_profiles": card.profiles.tolist() == cpu.profiles.tolist()})
    assert same_tokens, "generated tokens differ between card and CPU"
    assert card_launches == n_mlstm, (card_launches, n_mlstm)


def _involuntary_switches() -> int:
    """How often the kernel took the main (dispatching) thread off its core
    while it could still run: a host shared with other work shows here
    (a sandboxed kernel may not count them, and then reports 0)."""
    import resource
    return resource.getrusage(resource.RUSAGE_THREAD).ru_nivcsw


def seconds_by_block_kind(torch, fn, repeats, targets):
    """Host-clock seconds each of ``repeats`` calls of ``fn`` spends in
    each block kind (each block call wrapped in a synchronised timer,
    after the counted run), with the main thread's CPU seconds and
    involuntary context switches over the call: a thread that kept its
    core has CPU seconds close to the wall's and few switches.  targets:
    {kind: (module, function name)}, the functions the model looks up at
    call time."""
    spent = {}
    orig = {kind: getattr(mod, name) for kind, (mod, name) in targets.items()}

    def timed(kind):
        def call(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = orig[kind](*a, **kw)
            torch.cuda.synchronize()
            spent[kind] += time.perf_counter() - t0
            return out
        return call

    rows = []
    for kind, (mod, name) in targets.items():
        setattr(mod, name, timed(kind))
    try:
        for _ in range(repeats):
            spent.update({kind: 0.0 for kind in targets})
            cpu0, sw0 = time.thread_time(), _involuntary_switches()
            _, wall = sync_time(torch, fn)
            rows.append({"wall_s": wall,
                         **{f"{kind}_s": spent[kind] for kind in targets},
                         "main_thread_cpu_s": time.thread_time() - cpu0,
                         "involuntary_switches":
                         _involuntary_switches() - sw0,
                         "loadavg_1min": os.getloadavg()[0]})
    finally:
        for kind, (mod, name) in targets.items():
            setattr(mod, name, orig[kind])
    return rows


def _spread(xs):
    xs = sorted(xs)
    return {"median": xs[len(xs) // 2], "min": xs[0], "max": xs[-1]}


def phase_serve_xlstm(torch, kernels):
    """The LM path at xlstm-350m's published config whole: 24 layers
    alternating mLSTM and sLSTM (lead 2, scan 11 repeats of 2), d_model
    1024, 4 heads (mLSTM heads of 512, sLSTM heads of 256), vocab 50304,
    bf16, layernorm.  The reference's serving defaults (batch 4, 3
    clients, prompt 16, 16 steps) with a head bank over 2048-token
    sequences, the xLSTM paper's context length."""
    from repro_torch.configs.base import MLSTM, SLSTM
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch.serve import personalized_logits, serve
    from repro_torch.models.registry import build_model
    from repro_torch.telemetry import MetricLogger
    from repro_torch.utils.prng import make_generator
    from repro_torch.utils.tree import tree_leaves
    cfg = get_arch("xlstm-350m")
    model = build_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    params, init_s = sync_time(
        torch, lambda: model.init(make_generator(0, "cuda")))
    n_params = sum(t.numel() for t in tree_leaves(params))
    kw = dict(batch=4, steps=16, clients=3, prompt_len=16, seed=0,
              bank_seq=2048)

    reset_counts(kernels)                  # count this path's run alone
    res, wall = sync_time(torch, lambda: serve(
        cfg, params=params, device="cuda",
        log=MetricLogger("serve_xlstm", sys.stderr), **kw))
    counts = read_counts(kernels)
    peak = torch.cuda.max_memory_allocated()

    # one K3 launch per mLSTM layer: the head bank's one trunk forward runs
    # all clients' sequences at once; decoding takes the recurrent step
    expected = sum(kind == MLSTM for kind in cfg.layer_kinds())
    finite = bool(torch.isfinite(res.logits).all()
                  and torch.isfinite(res.bank_losses).all()
                  and torch.isfinite(res.head_bank.float()).all())
    shapes_ok = (tuple(res.generated.shape) == (kw["batch"], kw["steps"])
                 and tuple(res.logits.shape) == (kw["batch"], kw["steps"],
                                                 cfg.padded_vocab)
                 and tuple(res.head_bank.shape) == (
                     kw["clients"], cfg.d_model, cfg.padded_vocab))
    tokens_ok = bool(((res.generated >= 0)
                      & (res.generated < cfg.vocab_size)).all())
    emit({"phase": "serve_xlstm", "config": {
              "arch": cfg.name, "num_layers": cfg.num_layers,
              "layer_kinds": list(cfg.layer_kinds()),
              "d_model": cfg.d_model, "xlstm_heads": cfg.xlstm.num_heads,
              "mlstm_head_dim": int(cfg.d_model
                                    * cfg.xlstm.proj_factor_mlstm)
              // cfg.xlstm.num_heads,
              "slstm_head_dim": cfg.d_model // cfg.xlstm.num_heads,
              "vocab": cfg.padded_vocab, "dtype": cfg.dtype, **kw},
          "params": n_params, "init_s": init_s, "serve_wall_s": wall,
          "head_bank_s": res.bank_seconds, "decode_s": res.decode_seconds,
          "decode_tokens": res.tokens, "decode_tok_per_s": res.tok_per_s,
          "bank_losses": res.bank_losses.cpu().tolist(),
          "profiles": res.profiles.tolist(),
          "generated": res.generated.cpu().tolist(),
          "peak_mem_GB": peak / 1e9, "launches": counts,
          "mlstm_launches_expected": expected, "finite": finite,
          "shapes_ok": shapes_ok, "tokens_in_vocab": tokens_ok})
    assert finite, "non-finite logits or losses"
    assert shapes_ok and tokens_ok, "serve output has the wrong shape"
    assert counts["mlstm_chunk"] == expected == 12, (counts, expected)
    assert (counts["quantize"] == counts["flash_attention"]
            == counts["rglru_scan"] == 0), counts

    # where the time goes (after the counts): the head bank's one trunk
    # forward, by device kernel and by block kind, then one decode step
    toks = torch.randint(0, cfg.vocab_size, (6, 2048), device="cuda")

    def forward():
        with torch.no_grad():
            model.apply(params, {"tokens": toks})

    from repro_torch.models import xlstm as xm
    targets = {"mlstm": (xm, "mlstm_block_apply"),
               "slstm": (xm, "slstm_block_apply")}
    before = seconds_by_block_kind(torch, forward, FORWARD_REPEATS, targets)
    row, by_name = kernel_breakdown(torch, forward, 1)
    # every CUDA kernel of K3 (mlstm_chunk_fwd in float32; _gates,
    # _states and _outputs in bf16) carries this prefix
    k3 = {k: t / 1e3 for k, (t, _) in by_name.items() if "mlstm_chunk_" in k}
    k3_ms = sum(k3.values())
    after = seconds_by_block_kind(torch, forward, FORWARD_REPEATS, targets)
    rows = before + after
    n_slstm = sum(kind == SLSTM for kind in cfg.layer_kinds())
    emit({"phase": "serve_profile_xlstm", "what": "one trunk forward, 6 x "
          "2048 tokens, 24 layers, bf16", **row,
          "mlstm_kernel_ms": k3_ms,
          "mlstm_kernel_ms_by_name": {k[:90]: t for k, t in k3.items()},
          "mlstm_kernel_share_of_kernel_time": k3_ms
          / row["kernel_ms_sum_per_step"]
          if row["kernel_ms_sum_per_step"] else None,
          "host_cpus_usable": len(os.sched_getaffinity(0)),
          "by_block_kind": {"before_profile": before,
                            "after_profile": after},
          "wall_s": _spread([r["wall_s"] for r in rows]),
          "slstm_share": _spread([r["slstm_s"] / r["wall_s"] for r in rows]),
          "mlstm_share": _spread([r["mlstm_s"] / r["wall_s"] for r in rows]),
          "slstm_us_per_step_per_layer": _spread(
              [r["slstm_s"] / (n_slstm * toks.shape[1]) * 1e6
               for r in rows]),
          "main_thread_cpu_share": _spread(
              [r["main_thread_cpu_s"] / r["wall_s"] for r in rows])})

    cache = model.init_cache(kw["batch"], kw["prompt_len"] + kw["steps"],
                             dtype=torch.float32, device="cuda")
    bank32 = res.head_bank.to(torch.float32)
    tok = res.generated[:, :1]

    def decode():
        with torch.no_grad():
            h, _ = model.decode_step(params, tok, cache, kw["prompt_len"],
                                     return_hidden=True)
            personalized_logits(h.to(torch.float32), bank32, res.profiles)

    decode()                               # warm-up outside the profile
    row, _ = kernel_breakdown(torch, decode, 5)
    emit({"phase": "serve_profile_xlstm", "what": "one decode step, batch "
          "4, 24 layers, per-request float32 heads", **row})
    return counts["mlstm_chunk"]


# ------------------------------------------------------------------ K4 ----
def _rglru_inputs(torch, b, s, w, dtype, seed):
    """log_a <= 0 and b (B,S,W) in ``dtype``, h0 (B,W) float32, drawn as
    the reference's sweep draws them (tests/test_kernels.py:70-72)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    la = -torch.randn(b, s, w, generator=gen, device="cuda").abs() * 0.1
    bb = torch.randn(b, s, w, generator=gen, device="cuda")
    h0 = torch.randn(b, w, generator=gen, device="cuda")
    return la.to(dtype), bb.to(dtype), h0


def phase_check_rglru(torch, ops, ref):
    """K4 against its plain sequential version on the card, on the same
    inputs."""
    m = RGLRU_MAIN
    cases = []
    for b, s, w in [(2, 128, 64), (1, 256, 512), (3, 64, 128)]:
        for dtype in ("float32", "bfloat16"):       # the reference's sweep
            cases.append(((b, s, w), dtype))
    cases += [((6, 160, 256), "float32"),            # reduced model's bank
              ((2, 1, m["w"]), "float32"),           # one step
              ((2, 2047, 100), "float32"),           # ragged S and W
              ((1, 333, 37), "bfloat16")]
    # the training path's shapes (train_rglru): a local step's batch and
    # the head bank's and evaluations' one, float32 as the model's gates
    train = [((b, TRAIN_RGLRU["seq"], m["w"]), "float32")
             for b in train_batches(TRAIN_RGLRU)]
    cases += train
    cases += [((m["b"], m["s"], m["w"]), "bfloat16"),
              ((m["b"], m["s"], m["w"]), "float32")]  # the serving shape
    rows, worst = [], {"float32": 0.0, "bfloat16": 0.0}
    for i, (shape, dtype) in enumerate(cases):
        x = _rglru_inputs(torch, *shape, getattr(torch, dtype), i)
        got = ops.rglru_scan(*x)
        want = ref.rglru_scan_ref(*x)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        tol = RGLRU_TOL[dtype]
        ok = (bool(torch.allclose(got.float(), want.float(), rtol=tol,
                                  atol=tol))
              and got.dtype == x[0].dtype and got.shape == x[0].shape)
        worst[dtype] = max(worst[dtype], err)
        rows.append({"bsw": list(shape), "dtype": dtype, "max_abs_err": err,
                     "max_abs_out": float(want.float().abs().max()),
                     "ok": ok})
        del x, got, want
    # backward: the wrapper's VJP differentiates the sequential version, as
    # the reference's does; it is held against autograd through the
    # independent parallel-prefix form, so the values are checked as well
    # as the saved tensors and the gradients' dtypes
    x = _rglru_inputs(torch, 2, 48, 40, torch.float32, 99)
    w = torch.randn_like(x[0])
    leaves = [t.clone().requires_grad_() for t in x]
    (ops.rglru_scan(*leaves) * w).sum().backward()
    plain = [t.clone().requires_grad_() for t in x]
    (ref.rglru_scan_assoc(*plain) * w).sum().backward()
    grad_err = max(float((a.grad - b.grad).abs().max())
                   for a, b in zip(leaves, plain))
    grad_ok = all(torch.allclose(a.grad, b.grad, rtol=1e-4, atol=1e-4)
                  for a, b in zip(leaves, plain))
    bad = [r for r in rows if not r["ok"]]
    emit({"phase": "check_rglru", "kernel": "rglru_scan",
          "cases": len(rows), "tolerance": RGLRU_TOL,
          "max_abs_err": worst, "mismatches": bad, "main_shape": rows[-1],
          "train_shapes": rows[-2 - len(train):-2],
          "backward_max_abs_err": grad_err, "backward_ok": grad_ok})
    assert not bad and grad_ok, "K4 disagrees with its plain version"
    return max(worst.values())


def rglru_work(b, s, w, bytes_per_el=4):
    """What the function needs: log_a and b read once and h written once
    in their dtype, h0 read once in float32; 3 flops an element (exp,
    multiply, add)."""
    return 3 * b * s * w, 3 * b * s * w * bytes_per_el + 4 * b * w


def phase_time_rglru(torch, ops, ref):
    """K4 at the serving shape in float32: the kernel, its plain version
    and its bound.  No single PyTorch call computes a linear recurrence,
    so there is no library time."""
    m = RGLRU_MAIN
    x = _rglru_inputs(torch, m["b"], m["s"], m["w"], torch.float32, 7)
    kernel_ms = event_ms(torch, lambda: ops.rglru_scan(*x), iters=50,
                         warmup=5)
    plain_ms = event_ms(torch, lambda: ref.rglru_scan_ref(*x), iters=5,
                        warmup=1)
    flops, nbytes = rglru_work(m["b"], m["s"], m["w"])
    flop_ms = flops / FP32_FLOPS * 1e3
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    row = {"phase": "time_rglru", "kernel": "rglru_scan",
           "bsw": [m["b"], m["s"], m["w"]], "dtype": "float32",
           "kernel_ms": kernel_ms, "plain_ms": plain_ms,
           "bound_ms": max(flop_ms, byte_ms),
           "bound_by": "operations" if flop_ms >= byte_ms else "bytes",
           "flop_bound_ms": flop_ms, "byte_bound_ms": byte_ms,
           "flops": flops, "bytes": nbytes,
           "rate_source": "NVIDIA H100 SXM data sheet: 67 TFLOP/s float32, "
                          "3.35 TB/s HBM3",
           "kernel_GBps": nbytes / kernel_ms / 1e6,
           "library_ms": None,
           "library_note": "no single PyTorch call computes a linear "
                           "recurrence (no associative scan outside "
                           "torch.compile)"}
    emit(row)
    return row


# -------------------------------------------------- recurrentgemma serving -
def phase_reference_serve_rglru(torch, np, kernels):
    """serve() at recurrentgemma-2b.reduced(num_layers=8) (lead, scan and
    tail stages: six RG-LRU layers and two local-attention ones, window
    64) on the card against the same call on the CPU, with the same
    weights and seed.  The head bank runs on 160-token sequences, so the
    window binds.  Tolerances as for gemma3: 1e-4 on the head bank, the
    losses and the logits; the tokens must be equal."""
    from repro_torch.configs.base import LOCAL_ATTN, RGLRU
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch.serve import serve
    from repro_torch.models.registry import build_model
    from repro_torch.telemetry import MetricLogger
    from repro_torch.utils.prng import make_generator
    from repro_torch.utils.tree import tree_map
    cfg = get_arch("recurrentgemma-2b").reduced(num_layers=8)
    params = build_model(cfg).init(make_generator(0, "cpu"))
    kw = dict(batch=4, steps=16, clients=3, prompt_len=16, seed=0,
              bank_seq=160,
              log=MetricLogger("reference_serve_rglru", sys.stderr))
    reset_counts(kernels)
    card = serve(cfg, params=tree_map(lambda t: t.cuda(), params),
                 device="cuda", **kw)
    card_launches = read_counts(kernels)
    cpu = serve(cfg, params=params, device="cpu", **kw)
    diffs = {}
    for name in ("head_bank", "logits", "bank_losses"):
        a = getattr(card, name).cpu().numpy()
        b = getattr(cpu, name).numpy()
        assert np.isfinite(a).all(), name
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4, err_msg=name)
        diffs[name] = float(np.abs(a - b).max())
    same_tokens = card.generated.cpu().tolist() == cpu.generated.tolist()
    kinds = cfg.layer_kinds()
    emit({"phase": "reference_serve_rglru", "config": cfg.name,
          "layer_kinds": list(kinds), "stages": ["lead", "scan", "tail"],
          "bank_seq": 160, "cuda_vs_cpu_max_abs_diff": diffs, "tol": 1e-4,
          "card_launches": card_launches, "same_tokens": same_tokens,
          "same_profiles": card.profiles.tolist() == cpu.profiles.tolist()})
    assert same_tokens, "generated tokens differ between card and CPU"
    assert card_launches["rglru_scan"] == sum(k == RGLRU for k in kinds)
    assert card_launches["flash_attention"] == sum(k == LOCAL_ATTN
                                                   for k in kinds)


def phase_serve_rglru(torch, kernels):
    """The LM path at recurrentgemma-2b's published config whole: 26
    layers in the Griffin pattern (lead: 2 RG-LRU; scan: 8 repeats of
    local attention, RG-LRU, RG-LRU), d_model 2560, 10 query heads of 256
    over one kv head, d_ff 7680, lru_width 2560, conv 4, window 2048,
    vocab 256000, bf16.  The reference's serving defaults (batch 4, 3
    clients, prompt 16, 16 steps) with a head bank over 2048-token
    sequences."""
    from repro_torch.configs.base import LOCAL_ATTN, RGLRU
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch.serve import personalized_logits, serve
    from repro_torch.models import attention as am
    from repro_torch.models import rglru as rm
    from repro_torch.models import transformer as tm
    from repro_torch.models.registry import build_model
    from repro_torch.telemetry import MetricLogger
    from repro_torch.utils.prng import make_generator
    from repro_torch.utils.tree import tree_leaves
    cfg = get_arch("recurrentgemma-2b")
    model = build_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    params, init_s = sync_time(
        torch, lambda: model.init(make_generator(0, "cuda")))
    n_params = sum(t.numel() for t in tree_leaves(params))
    kw = dict(batch=4, steps=16, clients=3, prompt_len=16, seed=0,
              bank_seq=2048)

    reset_counts(kernels)                  # count this path's run alone
    res, wall = sync_time(torch, lambda: serve(
        cfg, params=params, device="cuda",
        log=MetricLogger("serve_rglru", sys.stderr), **kw))
    counts = read_counts(kernels)
    peak = torch.cuda.max_memory_allocated()

    # one K4 launch per RG-LRU layer and one K2 launch per local-attention
    # layer: the head bank's one trunk forward runs all clients' sequences
    # at once; decoding takes the recurrent step and dense attention over
    # the cache
    kinds = cfg.layer_kinds()
    expected = {"rglru_scan": sum(k == RGLRU for k in kinds),
                "flash_attention": sum(k == LOCAL_ATTN for k in kinds)}
    finite = bool(torch.isfinite(res.logits).all()
                  and torch.isfinite(res.bank_losses).all()
                  and torch.isfinite(res.head_bank.float()).all())
    shapes_ok = (tuple(res.generated.shape) == (kw["batch"], kw["steps"])
                 and tuple(res.logits.shape) == (kw["batch"], kw["steps"],
                                                 cfg.padded_vocab)
                 and tuple(res.head_bank.shape) == (
                     kw["clients"], cfg.d_model, cfg.padded_vocab))
    tokens_ok = bool(((res.generated >= 0)
                      & (res.generated < cfg.vocab_size)).all())
    emit({"phase": "serve_rglru", "config": {
              "arch": cfg.name, "num_layers": cfg.num_layers,
              "layer_kinds": list(kinds), "d_model": cfg.d_model,
              "heads": cfg.num_heads, "kv_heads": cfg.num_kv_heads,
              "head_dim": cfg.head_dim, "d_ff": cfg.d_ff,
              "lru_width": cfg.rglru.lru_width,
              "conv_kernel": cfg.rglru.conv_kernel,
              "window": cfg.sliding_window, "vocab": cfg.padded_vocab,
              "dtype": cfg.dtype, **kw},
          "params": n_params, "init_s": init_s, "serve_wall_s": wall,
          "head_bank_s": res.bank_seconds, "decode_s": res.decode_seconds,
          "decode_tokens": res.tokens, "decode_tok_per_s": res.tok_per_s,
          "bank_losses": res.bank_losses.cpu().tolist(),
          "profiles": res.profiles.tolist(),
          "generated": res.generated.cpu().tolist(),
          "peak_mem_GB": peak / 1e9, "launches": counts,
          "launches_expected": expected, "finite": finite,
          "shapes_ok": shapes_ok, "tokens_in_vocab": tokens_ok})
    assert finite, "non-finite logits or losses"
    assert shapes_ok and tokens_ok, "serve output has the wrong shape"
    assert expected == {"rglru_scan": 18, "flash_attention": 8}, expected
    assert all(counts[k] == n for k, n in expected.items()), (counts,
                                                             expected)
    assert counts["quantize"] == counts["mlstm_chunk"] == 0, counts

    # where the time goes (after the counts): the head bank's one trunk
    # forward by block kind on the host's clock, then by device kernel,
    # then one decode step
    toks = torch.randint(0, cfg.vocab_size, (6, 2048), device="cuda")

    def forward():
        with torch.no_grad():
            model.apply(params, {"tokens": toks})

    targets = {"rglru": (rm, "rglru_block_apply"),
               "local_attn": (am, "attn_apply"), "mlp": (tm, "mlp_apply")}
    rows = seconds_by_block_kind(torch, forward, RGLRU_FORWARD_REPEATS,
                                 targets)
    row, by_name = kernel_breakdown(torch, forward, 1)
    k4_ms = sum(t for k, (t, _) in by_name.items()
                if "rglru_scan_fwd" in k) / 1e3
    k2_ms = sum(t for k, (t, _) in by_name.items()
                if "flash_fwd" in k) / 1e3
    kernel_ms = row["kernel_ms_sum_per_step"]
    emit({"phase": "serve_profile_rglru", "what": "one trunk forward, 6 x "
          "2048 tokens, 26 layers, bf16", **row,
          "rglru_kernel_ms": k4_ms, "flash_kernel_ms": k2_ms,
          "rglru_kernel_share_of_kernel_time": k4_ms / kernel_ms
          if kernel_ms else None,
          "flash_kernel_share_of_kernel_time": k2_ms / kernel_ms
          if kernel_ms else None,
          "by_block_kind": rows,
          "wall_s": _spread([r["wall_s"] for r in rows]),
          **{f"{kind}_share": _spread([r[f"{kind}_s"] / r["wall_s"]
                                       for r in rows]) for kind in targets},
          "main_thread_cpu_share": _spread(
              [r["main_thread_cpu_s"] / r["wall_s"] for r in rows])})

    cache = model.init_cache(kw["batch"], kw["prompt_len"] + kw["steps"],
                             dtype=torch.float32, device="cuda")
    bank32 = res.head_bank.to(torch.float32)
    tok = res.generated[:, :1]

    def decode():
        with torch.no_grad():
            h, _ = model.decode_step(params, tok, cache, kw["prompt_len"],
                                     return_hidden=True)
            personalized_logits(h.to(torch.float32), bank32, res.profiles)

    decode()                               # warm-up outside the profile
    row, _ = kernel_breakdown(torch, decode, 5)
    emit({"phase": "serve_profile_rglru", "what": "one decode step, batch "
          "4, 26 layers, per-request float32 heads", **row})
    return counts["rglru_scan"], counts["flash_attention"]


# --------------------------------------------------------- LM training ----
def _train_forwards(kw) -> int:
    """Trunk forwards of one ``train()``: a forward per local step of each
    client and round, then the head bank's one and the two evaluations'
    (the backward differentiates the plain versions: no launch)."""
    return kw["rounds"] * kw["clients"] * kw["local_steps"] + 3


def _replicas_equal(torch, params) -> bool:
    from repro_torch.utils.tree import tree_leaves
    return all(torch.equal(x[c], x[0]) for x in tree_leaves(params)
               for c in range(1, x.shape[0]))


def _heads_frozen(torch, params, head0) -> bool:
    w = params["lm_head"]["w"]
    return all(torch.equal(w[c], head0) for c in range(w.shape[0]))


def phase_reference_train(torch, np, kernels):
    """train() at xlstm-350m.reduced() (float32: K3's float32 route) on the
    card against the same call on the CPU: the same parameters and
    batches, 2 rounds of 2 clients.  Per-round losses, the final
    parameters, the head bank and both evaluations within TRAIN_TOL
    (K3's 2e-4); on the card the head stays bit-identical and the
    clients equal, and K3 runs once per mLSTM layer a forward."""
    from repro_torch.configs.base import MLSTM
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch.train import train
    from repro_torch.models.registry import build_model
    from repro_torch.telemetry import MetricLogger
    from repro_torch.utils.prng import make_generator
    from repro_torch.utils.tree import path_leaves, tree_map
    cfg = get_arch("xlstm-350m").reduced()
    params = build_model(cfg).init(make_generator(0, "cpu"))
    log = MetricLogger("reference_train", sys.stderr)
    reset_counts(kernels)
    card = train(cfg, params=tree_map(lambda t: t.cuda(), params),
                 device="cuda", log=log, **TRAIN_REFERENCE)
    launches = read_counts(kernels)
    cpu = train(cfg, params=params, device="cpu", log=log, **TRAIN_REFERENCE)
    diffs = {"losses": float(np.abs(np.subtract(card.losses,
                                                cpu.losses)).max())}
    np.testing.assert_allclose(card.losses, cpu.losses, **TRAIN_TOL,
                               err_msg="losses")
    for name in ("head_bank", "finetune_losses", "global_eval",
                 "personalized_eval"):
        a = getattr(card, name).cpu().numpy()
        b = getattr(cpu, name).numpy()
        assert np.isfinite(a).all(), name
        np.testing.assert_allclose(a, b, **TRAIN_TOL, err_msg=name)
        diffs[name] = float(np.abs(a - b).max())
    worst = 0.0
    cpu_leaves = dict(path_leaves(cpu.params))
    for path, a in path_leaves(card.params):
        a, b = a.cpu().numpy(), cpu_leaves[path].numpy()
        np.testing.assert_allclose(a, b, **TRAIN_TOL, err_msg=path)
        worst = max(worst, float(np.abs(a - b).max()))
    diffs["params"] = worst
    n_mlstm = sum(k == MLSTM for k in cfg.layer_kinds())
    expected = _train_forwards(TRAIN_REFERENCE) * n_mlstm
    frozen = _heads_frozen(torch, card.params, params["lm_head"]["w"].cuda())
    synced = _replicas_equal(torch, card.params)
    emit({"phase": "reference_train", "config": cfg.name,
          "dtype": cfg.dtype, **TRAIN_REFERENCE,
          "losses_card": card.losses, "losses_cpu": cpu.losses,
          "cuda_vs_cpu_max_abs_diff": diffs, "tol": TRAIN_TOL,
          "gain_card": card.personalization_gain,
          "gain_cpu": cpu.personalization_gain, "launches": launches,
          "mlstm_launches_expected": expected, "head_frozen": frozen,
          "clients_equal": synced})
    assert frozen and synced, (frozen, synced)
    assert launches["mlstm_chunk"] == expected, (launches, expected)
    assert (launches["quantize"] == launches["flash_attention"]
            == launches["rglru_scan"] == 0), launches
    return launches


def backward_seconds_by_block_kind(torch, loss_fn, repeats, targets):
    """Host-clock seconds of each block kind's share of a backward pass:
    each block call of the forward gets gradient hooks on its output
    (fires when its backward starts) and on its input (fires once its
    backward is done), each synchronised; the blocks run one after
    another, so the spans do not overlap.  ``loss_fn`` builds the graph
    (its forward is not timed); targets as ``seconds_by_block_kind``."""
    spent, starts = {}, {}
    orig = {kind: getattr(mod, name) for kind, (mod, name) in targets.items()}

    def stamp():
        torch.cuda.synchronize()
        return time.perf_counter()

    def hooked(kind):
        def call(p, cfg, x, *a, **kw):
            y, cache = orig[kind](p, cfg, x, *a, **kw)
            key = object()

            def begin(g):
                starts[key] = stamp()

            def end(g):
                spent[kind] += stamp() - starts.pop(key)

            y.register_hook(begin)
            x.register_hook(end)
            return y, cache
        return call

    rows = []
    for kind, (mod, name) in targets.items():
        setattr(mod, name, hooked(kind))
    try:
        for _ in range(repeats):
            spent.update({kind: 0.0 for kind in targets})
            loss, leaves = loss_fn()
            _, wall = sync_time(torch, lambda: torch.autograd.grad(
                loss, leaves))
            rows.append({"wall_s": wall, **{f"{kind}_s": spent[kind]
                                            for kind in targets}})
            del loss, leaves
    finally:
        for kind, (mod, name) in targets.items():
            setattr(mod, name, orig[kind])
    return rows


def phase_train_xlstm(torch, kernels, kw=TRAIN_XLSTM, name="train_xlstm",
                      profile=True, layers=None):
    """PHSFL training at xlstm-350m's published widths (d_model 1024,
    mLSTM heads of 512, vocab 50304, bf16; 24 layers whole, ``layers``
    cuts the depth: TRAIN_XLSTM_LAYERS, TRAIN_XLSTM_CONTEXT_LAYERS) through
    train(): the reference CLI's traffic (4 clients in 1 ES, kappa0 = 2
    local steps of micro-batch 2, 5 head steps) with lr 0.01, the paper's
    eta; TRAIN_XLSTM runs 1 round at 256 tokens a sequence (the sLSTM's
    Python loop over time), TRAIN_XLSTM_CONTEXT one round of 2 clients x
    one step at the published 2048.
    Counts set to 0 just before and read just after.
    Fails on a non-finite loss, a head leaf that moved, clients that
    differ after the edge step, or a personalization gain <= 0 (on the
    fine-tune batch, as the reference evaluates it).  Then, with
    ``profile``, one local step's profile."""
    from repro_torch.configs.base import MLSTM, TrainConfig
    from repro_torch.configs.registry import get_arch
    from repro_torch.core.phsfl import local_steps, build_optimizer
    from repro_torch.launch.train import _client_round_batch, train
    from repro_torch.models import xlstm as xm
    from repro_torch.models.registry import build_model
    from repro_torch.telemetry import MetricLogger
    from repro_torch.utils.prng import make_generator
    from repro_torch.utils.tree import tree_leaves, tree_map
    cfg = get_arch("xlstm-350m")
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    model = build_model(cfg)
    params = model.init(make_generator(kw["seed"], "cuda"))
    head0 = params["lm_head"]["w"].clone()
    n_params = sum(t.numel() for t in tree_leaves(params))

    reset_counts(kernels)                  # count this path's run alone
    res, wall = sync_time(torch, lambda: train(
        cfg, params=params, device="cuda",
        log=MetricLogger(name, sys.stderr), **kw))
    del params
    counts = read_counts(kernels)
    kinds = cfg.layer_kinds()
    expected = _train_forwards(kw) * sum(k == MLSTM for k in kinds)
    finite = (all(math.isfinite(v) for v in res.losses)
              and bool(torch.isfinite(res.global_eval).all()
                       and torch.isfinite(res.personalized_eval).all()
                       and torch.isfinite(res.finetune_losses).all()))
    frozen = _heads_frozen(torch, res.params, head0)
    synced = _replicas_equal(torch, res.params)
    gain = res.personalization_gain
    changes = [f"{k} {kw[k]} (the CLI's {v})" for k, v in
               (("clients", 4), ("local_steps", 2)) if kw[k] != v]
    if kw["seq"] != 2048:
        changes.append(f"seq {kw['seq']} (published context 2048)")
    changes = ", ".join(changes + ["lr 0.01 (the paper's eta; the CLI's "
                                   "default is 0.05)"])
    emit({"phase": name, "config": {
              "arch": cfg.name, "num_layers": cfg.num_layers,
              "d_model": cfg.d_model, "vocab": cfg.padded_vocab,
              "dtype": cfg.dtype, "edge_servers": 1, **kw,
              "changes": changes},
          "params": n_params, "train_wall_s": wall,
          "round_wall_s": res.round_seconds,
          "tokens_per_round": res.tokens_per_round,
          "train_tokens_per_s": res.tokens_per_s,
          "peak_mem_GB": res.peak_mem_GB, "losses": res.losses,
          "finetune_losses": res.finetune_losses.cpu().tolist(),
          "global_eval": res.global_eval.cpu().tolist(),
          "personalized_eval": res.personalized_eval.cpu().tolist(),
          "personalization_gain": gain, "launches": counts,
          "mlstm_launches_expected": expected,
          "mlstm_launches_expected_from": "(rounds x clients x kappa0 "
          f"local-step forwards + head bank + 2 evals) x "
          f"{sum(k == MLSTM for k in kinds)} mLSTM layers",
          "finite": finite, "head_frozen": frozen, "clients_equal": synced})
    assert finite, "non-finite loss"
    assert frozen, "a head leaf moved"
    assert synced, "clients differ after the edge step"
    assert gain > 0, gain
    assert counts["mlstm_chunk"] == expected, (counts, expected)
    assert (counts["quantize"] == counts["flash_attention"]
            == counts["rglru_scan"] == 0), counts
    if not profile:
        return counts

    # one local step (forward, backward, masked SGD update) of client 0
    # on a fresh micro-batch, after the counts: host-clock forward and
    # backward, each block kind's share of either, the device's busy
    # share and kernel time by name
    p1 = tree_map(lambda x: x[0], res.params)
    tcfg = TrainConfig(learning_rate=kw["lr"], remat=False)
    opt, mask = build_optimizer(model, tcfg, params=p1)
    s1 = opt.init(p1)
    batch = _client_round_batch(cfg, 1, 1, kw["micro"], kw["seq"],
                                seed=4321, device="cuda")
    batch = {k: v[0] for k, v in batch.items()}          # (1, micro, seq)
    mb = {k: v[0] for k, v in batch.items()}
    local = local_steps(model, opt, mask, tcfg)
    local(p1, s1, batch)                   # warm-up outside the timings
    fwd, bwd = [], []
    for _ in range(TRAIN_STEP_REPEATS):
        leaves = tree_map(lambda x, m: x.detach().requires_grad_(m), p1,
                          mask)
        loss, f = sync_time(torch, lambda: model.loss(leaves, mb))
        _, b = sync_time(torch, lambda: torch.autograd.grad(
            loss, [t for t in tree_leaves(leaves) if t.requires_grad]))
        fwd.append(f)
        bwd.append(b)
        del leaves, loss
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    _, step_s = sync_time(torch, lambda: local(p1, s1, batch))
    step_peak = (torch.cuda.max_memory_allocated() - held) / 1e9
    # the reference's default remat ("full") runs each checkpointed
    # layer's forward again in the backward, the sLSTM's loop over time
    # with it: the same step under it
    remat_local = local_steps(model, opt, mask,
                              dataclasses.replace(tcfg, remat=True))
    torch.cuda.reset_peak_memory_stats()
    _, remat_s = sync_time(torch, lambda: remat_local(p1, s1, batch))
    remat_peak = (torch.cuda.max_memory_allocated() - held) / 1e9
    targets = {"mlstm": (xm, "mlstm_block_apply"),
               "slstm": (xm, "slstm_block_apply")}
    by_kind = seconds_by_block_kind(torch, lambda: model.loss(tree_map(
        lambda x, m: x.detach().requires_grad_(m), p1, mask), mb),
        TRAIN_STEP_REPEATS, targets)

    def graph():
        leaves = tree_map(lambda x, m: x.detach().requires_grad_(m), p1,
                          mask)
        return (model.loss(leaves, mb),
                [t for t in tree_leaves(leaves) if t.requires_grad])

    bwd_by_kind = backward_seconds_by_block_kind(
        torch, graph, TRAIN_STEP_REPEATS, targets)
    row, by_name = kernel_breakdown(torch, lambda: local(p1, s1, batch), 1)
    k3_ms = sum(t for k, (t, _) in by_name.items()
                if "mlstm_chunk_" in k) / 1e3
    emit({"phase": "train_profile_xlstm", "what": "one local step of one "
          f"client: {kw['micro']} x {kw['seq']} tokens, 24 layers, bf16",
          "step_wall_s": step_s, "step_peak_GB_above_held": step_peak,
          "remat_full_step_wall_s": remat_s,
          "remat_full_step_peak_GB_above_held": remat_peak,
          "remat_full_over_plain_step": remat_s / step_s,
          "forward_s": _spread(fwd),
          "backward_s": _spread(bwd),
          "forward_by_block_kind": by_kind,
          "slstm_share_of_forward_by_kind": _spread(
              [r["slstm_s"] / r["wall_s"] for r in by_kind]),
          "backward_by_block_kind": bwd_by_kind,
          "slstm_share_of_backward_by_kind": _spread(
              [r["slstm_s"] / r["wall_s"] for r in bwd_by_kind]),
          "mlstm_share_of_backward_by_kind": _spread(
              [r["mlstm_s"] / r["wall_s"] for r in bwd_by_kind]),
          **row, "mlstm_kernel_ms": k3_ms,
          "host_cpus_usable": len(os.sched_getaffinity(0))})
    return counts


def phase_train_rglru(torch, kernels):
    """PHSFL training at recurrentgemma-2b's published widths (d_model
    2560, 10 query heads of 256 over one kv head, d_ff 7680, lru_width
    2560, window 2048, vocab 256000, bf16), cut in depth to 3 layers
    (RG-LRU, RG-LRU, local attention): train() with 2 clients, 1 round of
    one step on 2 x 512 tokens, then one make_host_round with 2 ESs of
    one client and global_sync=True, so the global step of Eq. 16 runs on
    the card.  K4 and K2 once per RG-LRU and attention layer a forward;
    finite losses; the head frozen; all clients equal after the global
    step."""
    from repro_torch.configs.base import (LOCAL_ATTN, RGLRU, HierarchyConfig,
                                          TrainConfig)
    from repro_torch.configs.registry import get_arch
    from repro_torch.core.phsfl import make_host_round
    from repro_torch.launch.train import _client_round_batch, train
    from repro_torch.models.registry import build_model
    from repro_torch.telemetry import MetricLogger
    from repro_torch.utils.prng import make_generator
    from repro_torch.utils.tree import tree_leaves
    cfg = dataclasses.replace(get_arch("recurrentgemma-2b"),
                              num_layers=TRAIN_RGLRU_LAYERS)
    kinds = cfg.layer_kinds()
    model = build_model(cfg)
    kw = TRAIN_RGLRU
    params = model.init(make_generator(kw["seed"], "cuda"))
    head0 = params["lm_head"]["w"].clone()
    n_params = sum(t.numel() for t in tree_leaves(params))

    reset_counts(kernels)                  # count this path's run alone
    res, wall = sync_time(torch, lambda: train(
        cfg, params=params, device="cuda",
        log=MetricLogger("train_rglru", sys.stderr), **kw))
    del params
    C = kw["clients"]
    h2 = HierarchyConfig(num_edge_servers=C, clients_per_es=1,
                         kappa0=kw["local_steps"], kappa1=1)
    t2 = TrainConfig(learning_rate=kw["lr"], remat=False)
    rnd = make_host_round(model, h2, t2, num_clients=C, global_sync=True)
    batch = _client_round_batch(cfg, C, kw["local_steps"], kw["micro"],
                                kw["seq"], seed=kw["seed"] + kw["rounds"],
                                device="cuda")
    au = torch.ones(C, device="cuda")            # one client an ES
    ab = torch.full((C,), 1.0 / C, device="cuda")
    (p2, _, met), global_s = sync_time(
        torch, lambda: rnd.fn(res.params, res.opt_state, batch, au, ab))
    counts = read_counts(kernels)
    peak = torch.cuda.max_memory_allocated() / 1e9
    forwards = _train_forwards(kw) + C * kw["local_steps"]
    expected = {"rglru_scan": forwards * sum(k == RGLRU for k in kinds),
                "flash_attention": forwards * sum(k == LOCAL_ATTN
                                                  for k in kinds)}
    losses = res.losses + [float(met["loss"])]
    finite = (all(math.isfinite(v) for v in losses)
              and bool(torch.isfinite(res.global_eval).all()
                       and torch.isfinite(res.personalized_eval).all()))
    frozen = _heads_frozen(torch, p2, head0)
    synced = _replicas_equal(torch, p2)
    emit({"phase": "train_rglru", "config": {
              "arch": cfg.name, "num_layers": cfg.num_layers,
              "layer_kinds": list(kinds), "d_model": cfg.d_model,
              "heads": cfg.num_heads, "kv_heads": cfg.num_kv_heads,
              "lru_width": cfg.rglru.lru_width, "vocab": cfg.padded_vocab,
              "dtype": cfg.dtype, **kw, "global_round": {
                  "edge_servers": C, "clients_per_es": 1,
                  "global_sync": True}},
          "params": n_params, "train_wall_s": wall,
          "round_wall_s": res.round_seconds, "global_round_s": global_s,
          "train_tokens_per_s": res.tokens_per_s, "peak_mem_GB": peak,
          "losses": losses,
          "personalization_gain": res.personalization_gain,
          "launches": counts, "launches_expected": expected,
          "finite": finite, "head_frozen": frozen, "clients_equal": synced})
    assert finite, "non-finite loss"
    assert frozen and synced, (frozen, synced)
    assert all(counts[k] == n for k, n in expected.items()), (counts,
                                                             expected)
    assert counts["quantize"] == counts["mlstm_chunk"] == 0, counts
    return counts


def _npz_equal(np, a_path, b_path) -> list:
    """Keys whose arrays differ (in dtype, shape or any bit) between two
    checkpoint files, and keys in one only."""
    with np.load(a_path) as a, np.load(b_path) as b:
        bad = sorted(set(a.files) ^ set(b.files))
        for k in set(a.files) & set(b.files):
            x, y = a[k], b[k]
            if (x.dtype != y.dtype or x.shape != y.shape
                    or x.tobytes() != y.tobytes()):
                bad.append(k)
    return bad


def phase_resume_train(torch, np):
    """launch/train.py's main at the reduced config on the card, as the
    reference's ``make resume-smoke``: a 2-round run checkpointing every
    round, against the same run aborted after round 1 and resumed.  The
    final state files and final-params files must be equal array for
    array, bit for bit, and so must the final JSON."""
    from repro_torch.launch.train import main
    flags = ["--device", "cuda"] + RESUME_FLAGS
    with tempfile.TemporaryDirectory() as d, \
            contextlib.redirect_stdout(sys.stderr):
        whole = main(flags + ["--ckpt-dir", f"{d}/whole"])
        cut = main(flags + ["--ckpt-dir", f"{d}/cut", "--abort-after", "1"])
        resumed = main(flags + ["--ckpt-dir", f"{d}/cut", "--resume"])
        step = "ckpt_00000002.npz"
        bad = {name: _npz_equal(np, f"{d}/whole/{name}", f"{d}/cut/{name}")
               for name in (f"state/{step}", step)}
    same_json = (whole.final_loss == resumed.final_loss
                 and whole.personalization_gain
                 == resumed.personalization_gain)
    emit({"phase": "resume_train", "flags": flags,
          "aborted_after": cut.aborted_after,
          "resumed_from": resumed.start_round,
          "final_loss": [whole.final_loss, resumed.final_loss],
          "gain": [whole.personalization_gain,
                   resumed.personalization_gain],
          "differing_arrays": bad, "same_json": same_json})
    assert cut.aborted_after == 1 and resumed.start_round == 1
    assert not any(bad.values()), bad
    assert same_json


# ------------------------------------------------------ the wireless slice --
# The scheduler configurations of the CPU parity tests (tests/
# test_population.py's 20, at U = 8 over 6 rounds); the fault configs'
# FaultConfig as its kwargs.
COHORT_U = 8
_CB = dict(mean_uplink_mbps=8.0, mean_downlink_mbps=30.0, latency_s=0.01,
           deadline_s=1.5, energy_budget_j=20.0, tx_power_w=0.7,
           heterogeneity=0.5, seed=3)
_TRACE = tuple(tuple(5.0 + 3 * ((i * 7 + j * 3) % 5) for j in range(8))
               for i in range(4))
_TRACE_DOWN = tuple(tuple(20.0 + 5 * ((i * 3 + j) % 4) for j in range(8))
                    for i in range(4))
_OUTAGE = tuple((0, 1) if i % 3 == 1 else (0, 0) for i in range(6))
_PROP = dict(es_uplink_mbps=12.0, contention="proportional")
COHORT_CONFIGS = {
    "static": dict(model="static"), "rayleigh": dict(model="rayleigh"),
    "trace": dict(model="trace", trace=_TRACE),
    "trace_down": dict(model="trace", trace=_TRACE, trace_down=_TRACE_DOWN),
    "contend_eq": dict(model="rayleigh", es_uplink_mbps=12.0),
    "contend_prop": dict(model="rayleigh", **_PROP),
    "contend_noreshare": dict(model="rayleigh", reshare_uplink=False,
                              **_PROP),
    "pipeline": dict(model="rayleigh", pipeline=True),
    "pipeline_contend": dict(model="rayleigh", pipeline=True, **_PROP),
    "greedy_cut": dict(model="rayleigh", cut_policy="greedy",
                       compute_gflops=2.0, compute_heterogeneity=0.4,
                       compute_power_w=0.3),
    "deadline_cut": dict(model="rayleigh", cut_policy="deadline",
                         compute_gflops=2.0, compute_power_w=0.3, **_PROP),
    "topk": dict(model="rayleigh", selection="topk", topk=3,
                 es_uplink_mbps=10.0, contention="proportional"),
    "random": dict(model="rayleigh", selection="random",
                   participation_prob=0.6),
    "stale": dict(model="rayleigh", staleness_lambda=0.5),
    "ideal": dict(model="ideal"),
    "outage_reassoc": dict(model="rayleigh",
                           faults=dict(es_outage_trace=_OUTAGE), **_PROP),
    "outage_skip": dict(model="rayleigh", es_uplink_mbps=12.0,
                        faults=dict(es_outage_trace=_OUTAGE,
                                    failover="skip")),
    "harq": dict(model="rayleigh", faults=dict(erasure_prob=0.3,
                                               max_retries=2,
                                               backoff_s=0.02)),
    "crash": dict(model="rayleigh", faults=dict(crash_hazard=0.3)),
    "harq_outage_stale": dict(model="rayleigh", staleness_lambda=0.5,
                              es_uplink_mbps=12.0,
                              faults=dict(erasure_prob=0.25, max_retries=2,
                                          backoff_s=0.02,
                                          es_outage_trace=_OUTAGE)),
}
COHORT_TABLE = ("greedy_cut", "deadline_cut")
COHORT_ONE_ES = ("static", "rayleigh", "trace", "trace_down", "pipeline",
                 "greedy_cut", "random", "stale", "ideal", "harq", "crash")
# check_cohort at scale: the configs whose per-ES sums are not counts
# (proportional water-filling) and the top-k selection, 10**5 clients
COHORT_LARGE = ("contend_prop", "topk", "pipeline_contend")
COHORT_LARGE_N, COHORT_LARGE_ROUNDS = 100_000, 3
# cohort: benchmarks/cohort_bench.py's scenario (rayleigh, 25/100 Mbps,
# deadline 2 s, budget 500 J, heterogeneity 0.5, 800 Mbps shared ES
# uplinks, proportional contention) at its largest population
COHORT_BENCH_CHANNEL = dict(model="rayleigh", mean_uplink_mbps=25.0,
                            mean_downlink_mbps=100.0, latency_s=0.01,
                            deadline_s=2.0, energy_budget_j=500.0,
                            tx_power_w=0.7, heterogeneity=0.5,
                            es_uplink_mbps=800.0, contention="proportional",
                            seed=0)
COHORT_N, COHORT_ES, COHORT_SIZE, COHORT_ROUNDS = 10**6, 8, 512, 5
# reference_wireless / fedsim_wireless: the CPU parity tests' four networks
# (tests/test_torch_fedsim_wireless.py) on phase_reference's small CNN
_FB = dict(mean_uplink_mbps=8.0, mean_downlink_mbps=30.0, latency_s=0.01,
           energy_budget_j=20.0, tx_power_w=0.7, heterogeneity=0.5, seed=3)
FEDSIM_NETWORKS = {
    "rayleigh": dict(model="rayleigh", deadline_s=0.06, **_FB),
    "stale": dict(model="rayleigh", deadline_s=0.1, staleness_lambda=0.5,
                  selection="random", participation_prob=0.5,
                  **{**_FB, "seed": 0}),
    "outage": dict(model="rayleigh", deadline_s=0.2, es_uplink_mbps=12.0,
                   contention="proportional",
                   faults=dict(es_outage_trace=((0, 1), (0, 0), (1, 0))),
                   **_FB),
    "population": dict(model="rayleigh", deadline_s=2.0,
                       es_uplink_mbps=12.0, contention="proportional",
                       **_FB),
}
FEDSIM_POPULATION = dict(num_es=2, seed=3, assignment="kmeans",
                         data_sigma=0.5)
# fedsim_wireless: the population the CNN trains over at full width
FEDSIM_WIRELESS_N = 10**6
# train_wireless: launch/train.py's flags on the reduced xlstm (float32,
# K3's float32 route), the network of the slice's CLI example
TRAIN_WIRELESS_FLAGS = ["--rounds", "2", "--clients", "2", "--seq", "64",
                        "--channel", "rayleigh", "--population", "64",
                        "--cut-policy", "greedy", "--cut-candidates", "1",
                        "2", "--erasure-prob", "0.3", "--ckpt-every", "1"]


def _wireless_config(kw):
    from repro_torch.configs import FaultConfig, WirelessConfig
    kw = dict(kw)
    if "faults" in kw:
        kw["faults"] = FaultConfig(**kw["faults"])
    return WirelessConfig(**kw)


def _cohort_pair(name, n, device):
    """The port's numpy oracle and its cohort core of a COHORT_CONFIGS
    entry over ``n`` clients (the tests' layout: one ES, or two halves;
    a shared ES uplink scaled by n / COHORT_U)."""
    import numpy as np
    from repro_torch.configs.phsfl_cnn import CONFIG as CNN
    from repro_torch.core.comm import comm_for_cnn, comm_table_for_cnn
    from repro_torch.wireless import make_scheduler
    from repro_torch.wireless.population import CohortScheduler
    kw = dict(COHORT_CONFIGS[name])
    if kw["model"] != "ideal":
        kw = {**_CB, **kw}
    if "es_uplink_mbps" in kw:
        # the same pipe per client as at U = 8, so shares stay comparable
        # to the private rates and clients still finish
        kw["es_uplink_mbps"] *= n / COHORT_U
    wcfg = _wireless_config(kw)
    es = None if name in COHORT_ONE_ES else np.arange(n) // (n // 2)
    ckw = dict(dataset_size=400, batch_size=16)
    if name in COHORT_TABLE:
        table = comm_table_for_cnn(CNN, **ckw)
        mk = lambda **e: make_scheduler(wcfg, n, kappa0=2, comm_table=table,
                                        es_assign=es, **e)
    else:
        comm = comm_for_cnn(CNN, **ckw)
        mk = lambda **e: make_scheduler(wcfg, n, comm, 2, es_assign=es, **e)
    return mk(), mk(cls=CohortScheduler, core_device=device)


def _report_diffs(np, a, b) -> list:
    """Fields in which two RoundReports differ (the tests' bar)."""
    bad = []
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            same = ((x is None) == (y is None)
                    and np.array_equal(np.asarray(x), np.asarray(y)))
        else:
            same = x == y
        if not same:
            bad.append(f.name)
    return bad


def phase_check_cohort(torch, np):
    """The float64 decision core on the card against the port's numpy
    oracle (which the CPU tests hold to the reference's), bit for bit:
    every RoundReport field and the carried state, on the 20 configs x 6
    rounds at U = 8 and on COHORT_LARGE at 10**5 clients for 3 rounds;
    and the per-group sum in np.bincount's order at 10**6 adversarial
    values (the water-filling totals a client on a boundary depends on)."""
    from repro_torch.wireless.scheduler_core import segment_sum_np_order
    t0 = time.perf_counter()
    bad = []
    rounds = 0
    cases = [(name, COHORT_U, 6) for name in COHORT_CONFIGS] + [
        (name, COHORT_LARGE_N, COHORT_LARGE_ROUNDS) for name in COHORT_LARGE]
    stats = {}
    for name, n, n_rounds in cases:
        oracle, core = _cohort_pair(name, n, "cuda")
        for r in range(n_rounds):
            want, got = oracle.step(r), core.step(r)
            rounds += 1
            diffs = _report_diffs(np, got, want)
            if diffs:
                bad.append({"config": name, "N": n, "round": r,
                            "fields": diffs})
            if n > COHORT_U:
                stats.setdefault(name, []).append(
                    {"scheduled": int(want.scheduled.sum()),
                     "participants": want.num_participants})
        for attr in ("energy_left", "_stale_pending", "_stale_age"):
            if not np.array_equal(getattr(core, attr), getattr(oracle, attr)):
                bad.append({"config": name, "N": n, "state": attr})
    rng = np.random.default_rng(0)
    n, groups = 10**6, 8
    x = np.where(rng.random(n) < 0.5, rng.lognormal(0.0, 8.0, n),
                 rng.random(n) * 1e-9)
    g = rng.integers(0, groups, n)
    want = np.bincount(g, weights=x, minlength=groups)
    got = segment_sum_np_order(torch.from_numpy(x).cuda(),
                               torch.from_numpy(g).cuda(), groups).cpu()
    pairwise_differs = not np.array_equal(
        want, [np.sum(x[g == k]) for k in range(groups)])
    sums_equal = bool(np.array_equal(got.numpy(), want))
    emit({"phase": "check_cohort", "device": "cuda", "rounds": rounds,
          "configs_u8": len(COHORT_CONFIGS), "large": list(COHORT_LARGE),
          "large_N": COHORT_LARGE_N, "large_rounds": stats,
          "mismatches": bad, "bit_identical": not bad,
          "segment_sum_1e6_equal": sums_equal,
          "segment_sum_order_matters": pairwise_differs,
          "seconds": time.perf_counter() - t0})
    assert not bad, bad
    assert sums_equal and pairwise_differs


@contextlib.contextmanager
def _timed(torch, owner, attr, bucket, key):
    """Accumulate the synchronised wall seconds of ``owner.attr`` calls."""
    orig = getattr(owner, attr)

    def wrapped(*a, **k):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = orig(*a, **k)
        torch.cuda.synchronize()
        bucket[key] += time.perf_counter() - t
        return out

    setattr(owner, attr, wrapped)
    try:
        yield
    finally:
        setattr(owner, attr, orig)


def phase_cohort(torch, np):
    """The population path at cohort_bench's scenario and largest size:
    10**6 registered clients over 8 k-means ESs, a cohort of 512 a round
    by pareto sampling.  Build, warm-up round, then COHORT_ROUNDS steady
    rounds, each split into stage A, stage B (device work, synchronised),
    host-to-device and device-to-host copies, the population's sampling
    and the channel's draws, and the rest on the host (the selection
    gate, the report and its numpy totals); peak device memory; then one
    round of the port's numpy oracle at the same N on this host, under
    the core's first cohort, whose report must equal the core's."""
    from repro_torch.configs import CNNConfig
    from repro_torch.core.comm import comm_for_cnn
    from repro_torch.wireless import make_scheduler
    from repro_torch.wireless import scheduler_core as core
    from repro_torch.wireless.channel import ChannelModel
    from repro_torch.wireless.population import (CohortScheduler,
                                                 Population,
                                                 make_cohort_scheduler)
    comm = comm_for_cnn(CNNConfig(), dataset_size=400, batch_size=16,
                        batches_per_epoch=1)
    wcfg = _wireless_config(COHORT_BENCH_CHANNEL)
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    pop = Population(COHORT_N, num_es=COHORT_ES, seed=0,
                     assignment="kmeans")
    sched = make_cohort_scheduler(wcfg, COHORT_N, comm, 1, population=pop,
                                  cohort_size=COHORT_SIZE, sampling="pareto",
                                  core_device="cuda")
    build_s = time.perf_counter() - t0
    rep0, warm_s = sync_time(torch, lambda: sched.step(0))
    first_cohort = sched.last_cohort.copy()
    parts, walls, splits = [rep0.num_participants], [], []
    for r in range(1, COHORT_ROUNDS + 1):
        b = dict.fromkeys(("stage_a", "stage_b", "h2d", "d2h", "sampling",
                           "channel_draws"), 0.0)
        with _timed(torch, core, "cohort_stage_a", b, "stage_a"), \
                _timed(torch, core, "cohort_stage_b", b, "stage_b"), \
                _timed(torch, CohortScheduler, "_f64", b, "h2d"), \
                _timed(torch, torch.Tensor, "cpu", b, "d2h"), \
                _timed(torch, Population, "sample_cohort", b, "sampling"), \
                _timed(torch, ChannelModel, "fades", b, "channel_draws"):
            rep, dt = sync_time(torch, lambda: sched.step(r))
        b["host_rest"] = dt - sum(b.values())
        walls.append(dt)
        splits.append(b)
        parts.append(rep.num_participants)
    peak = torch.cuda.max_memory_allocated() - base_mem
    oracle = make_scheduler(wcfg, COHORT_N, comm, 1,
                            es_assign=pop.es_assign)
    oracle.cohort_mask = pop.cohort_mask(first_cohort)
    orep, oracle_s = sync_time(torch, lambda: oracle.step(0))
    diffs = _report_diffs(np, rep0, orep)
    emit({"phase": "cohort", "N": COHORT_N, "num_es": COHORT_ES,
          "assignment": "kmeans", "cohort_size": COHORT_SIZE,
          "sampling": "pareto", "channel": COHORT_BENCH_CHANNEL,
          "build_s": build_s, "warmup_s": warm_s,
          "wall_s_per_round_median": float(np.median(walls)),
          "wall_s_per_round_max": float(np.max(walls)),
          "wall_s_per_round": walls, "split_s": splits,
          "participation": float(np.mean(parts)) / COHORT_SIZE,
          "participants": parts, "peak_device_GB": peak / 1e9,
          "oracle_round_s": oracle_s,
          "oracle_equal_on_round_0": not diffs, "oracle_diffs": diffs})
    assert not diffs, diffs
    assert all(0 < p <= COHORT_SIZE for p in parts), parts


def _small_fedsim(name, device):
    FedSim, CNNConfig, H, T, make_data, _ = _fedsim_parts()
    from repro_torch.wireless.population import Population
    pop = (Population(64, **FEDSIM_POPULATION) if name == "population"
           else None)
    return FedSim(CNNConfig(image_size=16, conv1_filters=8,
                            conv2_filters=16, fc_hidden=32),
                  make_data(4, 0.5, image_size=16, train_per_class=30,
                            test_per_class=10, seed=0),
                  H(num_edge_servers=2, clients_per_es=2, kappa0=2,
                    kappa1=2),
                  T(learning_rate=0.05, batch_size=8, finetune_steps=3,
                    finetune_lr=0.05), batches_per_epoch=2, seed=0,
                  wireless=_wireless_config(FEDSIM_NETWORKS[name]),
                  population=pop, sampling="rate", device=device)


def phase_reference_wireless(np):
    """FedSim's network modes, small, on the card against the CPU: the
    four networks of the CPU parity tests (a binding deadline, the stale
    fold, an ES outage with reassoc failover, population mode with the
    cohort core on each device).  Network rows equal; losses and the
    global parameters within phase_reference's 1e-4 (no codec)."""
    out = {}
    for name in FEDSIM_NETWORKS:
        runs = [_small_fedsim(name, d).run(rounds=2, log_every=1)
                for d in ("cuda", "cpu")]
        card, cpu = runs
        rows_equal = card.network == cpu.network
        a = [r[k] for r in card.history for k in ("train_loss",
                                                  "test_loss")]
        b = [r[k] for r in cpu.history for k in ("train_loss",
                                                 "test_loss")]
        diff = float(np.abs(np.subtract(a, b)).max())
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4, err_msg=name)
        for k in card.global_params:
            for n in card.global_params[k]:
                x = card.global_params[k][n].cpu().numpy()
                y = cpu.global_params[k][n].numpy()
                np.testing.assert_allclose(x, y, rtol=1e-4, atol=1e-4,
                                           err_msg=f"{name} {k}/{n}")
                diff = max(diff, float(np.abs(x - y).max()))
        out[name] = {"rows_equal": rows_equal, "max_abs_diff": diff,
                     "participants": [r["participants"]
                                      for r in card.network]}
        assert rows_equal, (name, card.network, cpu.network)
    emit({"phase": "reference_wireless", "cuda_vs_cpu": out, "tol": 1e-4})


def phase_fedsim_wireless(torch, np, kernels, data):
    """The CNN path at the paper's full width under cohort_bench's channel
    (int8 with stochastic rounding on all links, as ``fedsim``): 4 ESs x
    25 clients with staleness lambda 0.5 and the greedy cut policy over
    conv1 / conv2 / fc1, 2 global rounds; then 100 training slots sampled
    from 10**6 registered clients over 4 k-means ESs (lambda 0: the
    reference rejects staleness in population mode), one global round.
    The deadline: the median completion time of the clients the oracle
    schedules in round 0 of the first run with no deadline (on the CPU, at
    this run's byte and compute accounting), so about half finish.  K1's
    launches are counted over both runs against the count computed for
    them (the network only masks aggregation: every client trains).
    Returns the launches and, for fedsim_telemetry, the deadline and each
    run's rows, clock, history, round wall times and parameter sum."""
    FedSim, CNNConfig, H, T, _, link_codecs = _fedsim_parts()
    from repro_torch.models import cnn
    from repro_torch.wireless.population import Population
    cfg = CNNConfig()
    h = H(num_edge_servers=4, clients_per_es=25, kappa0=5, kappa1=3)
    t = T(batch_size=32, finetune_steps=10)
    bpe = 5
    codecs = link_codecs("int8")
    chan = dict(COHORT_BENCH_CHANNEL, cut_policy="greedy",
                cut_candidates=cnn.CUT_CANDIDATES)
    free = _wireless_config(dict(chan, deadline_s=float("inf"),
                                 staleness_lambda=0.5))
    probe = FedSim(cfg, data, h, t, batches_per_epoch=bpe, seed=0,
                   codecs=codecs, wireless=free, device="cpu")
    rep = probe.scheduler.step(0)
    deadline = float(np.median(rep.times_s[rep.scheduled]))
    del probe
    runs = {}
    context = {"deadline": deadline, "runs": {}}
    reset_counts(kernels)
    for name, rounds, network, population in (
            ("stale_greedy", 2, dict(chan, deadline_s=deadline,
                                     staleness_lambda=0.5), False),
            ("population", 1, dict(chan, deadline_s=deadline), True)):
        t0 = time.perf_counter()
        pop = (Population(FEDSIM_WIRELESS_N, num_es=h.num_edge_servers,
                          seed=0, assignment="kmeans")
               if population else None)
        sim = FedSim(cfg, data, h, t, batches_per_epoch=bpe, seed=0,
                     codecs=codecs, wireless=_wireless_config(network),
                     population=pop, sampling="pareto")
        build_s = time.perf_counter() - t0
        per_round, rows, hist = [], [], []
        samples = h.num_clients * t.batch_size * h.kappa0 * h.kappa1 * bpe
        for r in range(1, rounds + 1):
            res, dt = sync_time(torch, lambda: sim.run(rounds=r,
                                                       log_every=1))
            rows += res.network
            hist.append(res.history[-1])
            per_round.append({"round": r, "wall_s": dt,
                              "samples_per_s": samples / dt,
                              **res.history[-1]})
        runs[name] = {"build_s": build_s, "rounds": per_round,
                      "network": rows, "sim_time_s": res.total_sim_time_s}
        context["runs"][name] = {
            "network": rows, "sim_time_s": res.total_sim_time_s,
            "history": hist, "walls": [p["wall_s"] for p in per_round],
            "params_sum": float(sum(x.double().sum() for p in
                                    res.global_params.values()
                                    for x in p.values()))}
        finite = all(math.isfinite(r[k]) for r in per_round
                     for k in ("train_loss", "test_loss", "test_acc"))
        assert finite, (name, per_round)
    launches = read_counts(kernels)
    n_offload = sum(len(sim._stacked[k]) for k in cnn.client_keys_for(
        sim.cut))
    steps = h.kappa0 * h.kappa1 * bpe
    expected = 3 * (2 * steps + h.kappa1 * n_offload)     # 2 + 1 rounds
    net = [r for v in runs.values() for r in v["network"]]
    partial = any(0 < r["participants"] < r["scheduled"] for r in net)
    emit({"phase": "fedsim_wireless", "config": {
              "model": "CNNConfig()", "U": h.num_clients,
              "B": h.num_edge_servers, "kappa0": h.kappa0,
              "kappa1": h.kappa1, "batches_per_epoch": bpe,
              "batch": t.batch_size, "codecs": "int8 stochastic, all links",
              "channel": chan, "deadline_s": deadline,
              "deadline_rule": "median round-0 time of the oracle's "
                               "scheduled clients, no deadline",
              "population": FEDSIM_WIRELESS_N},
          "runs": runs, "launches": launches,
          "quantize_launches_expected": expected,
          "partial_participation": partial})
    assert launches["quantize"] == expected, (launches, expected)
    assert (launches["flash_attention"] == launches["mlstm_chunk"]
            == launches["rglru_scan"] == 0), launches
    assert partial, net
    return launches, context


def phase_train_wireless(torch, np, kernels):
    """launch/train.py in its network mode on the reduced xlstm (float32:
    K3's float32 route), population 64, greedy cuts over client depths 1
    and 2, erasures with HARQ.  The scheduler ``main`` builds from these
    flags (``scheduler_from_args``), on the card against the CPU, under
    ``train()`` from the same parameters (``main`` draws them on its
    device's generator): the network rows and the scheduler's state
    equal, losses, parameters and the head bank within TRAIN_TOL.  Then
    ``main`` itself on the card, killed after round 1 and resumed: the
    state files bit-equal to the uninterrupted run's, the scheduler's
    streams included."""
    from repro_torch.configs.base import MLSTM
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch.train import (main, parse_args,
                                          scheduler_from_args, train)
    from repro_torch.models.registry import build_model
    from repro_torch.telemetry import MetricLogger
    from repro_torch.utils.prng import make_generator
    from repro_torch.utils.tree import path_leaves, tree_map
    args = parse_args(TRAIN_WIRELESS_FLAGS)
    cfg = get_arch(args.arch).reduced()
    params = build_model(cfg).init(make_generator(args.seed, "cpu"))
    kw = dict(rounds=args.rounds, clients=args.clients,
              local_steps=args.local_steps, micro=args.micro, seq=args.seq,
              lr=args.lr, finetune_steps=args.finetune_steps,
              seed=args.seed)
    log = MetricLogger("train_wireless", sys.stderr)
    runs = {}
    for device in ("cuda", "cpu"):
        sched = scheduler_from_args(cfg, args, device)
        if device == "cuda":
            reset_counts(kernels)
        res = train(cfg, params=tree_map(lambda t: t.to(device), params),
                    device=device, log=log, scheduler=sched, **kw)
        if device == "cuda":
            launches = read_counts(kernels)
        runs[device] = (res, sched.state_dict())
    (card, card_state), (cpu, cpu_state) = runs["cuda"], runs["cpu"]
    sched_bad = [k for k in card_state
                 if np.asarray(card_state[k]).tobytes()
                 != np.asarray(cpu_state[k]).tobytes()]
    np.testing.assert_allclose(card.losses, cpu.losses, **TRAIN_TOL)
    diff = float(np.abs(np.subtract(card.losses, cpu.losses)).max())
    cpu_leaves = dict(path_leaves(cpu.params))
    for path, x in path_leaves(card.params):
        x, y = x.cpu().numpy(), cpu_leaves[path].numpy()
        np.testing.assert_allclose(x, y, **TRAIN_TOL, err_msg=path)
        diff = max(diff, float(np.abs(x - y).max()))
    x, y = card.head_bank.cpu().numpy(), cpu.head_bank.numpy()
    np.testing.assert_allclose(x, y, **TRAIN_TOL, err_msg="head_bank")
    n_mlstm = sum(k == MLSTM for k in cfg.layer_kinds())
    expected = _train_forwards(kw) * n_mlstm
    step = "ckpt_00000002.npz"
    flags = ["--device", "cuda", *TRAIN_WIRELESS_FLAGS]
    with tempfile.TemporaryDirectory() as d, \
            contextlib.redirect_stdout(sys.stderr):
        whole = main(flags + ["--ckpt-dir", f"{d}/whole"])
        cut = main(flags + ["--ckpt-dir", f"{d}/cut", "--abort-after", "1"])
        resumed = main(flags + ["--ckpt-dir", f"{d}/cut", "--resume"])
        bad = {name: _npz_equal(np, f"{d}/whole/{name}", f"{d}/cut/{name}")
               for name in (f"state/{step}", step)}
        with np.load(f"{d}/whole/state/{step}") as z:
            sched_keys = sorted(k for k in z.files
                                if k.startswith("scheduler/"))
    emit({"phase": "train_wireless", "flags": TRAIN_WIRELESS_FLAGS,
          "network_card": card.network,
          "network_equal": card.network == cpu.network,
          "losses_card": card.losses, "losses_cpu": cpu.losses,
          "cuda_vs_cpu_max_abs_diff": diff, "tol": TRAIN_TOL,
          "scheduler_state_differs": sched_bad, "launches": launches,
          "mlstm_launches_expected": expected,
          "resumed_from": resumed.start_round,
          "resume_network_equal": resumed.network == whole.network[1:],
          "state_scheduler_keys": sched_keys,
          "differing_arrays_after_resume": bad})
    assert card.network == cpu.network, (card.network, cpu.network)
    assert not sched_bad, sched_bad
    assert cut.aborted_after == 1 and resumed.start_round == 1
    assert resumed.network == whole.network[1:]
    assert not any(bad.values()), bad
    assert "scheduler/fault_rng" in sched_keys, sched_keys
    assert launches["mlstm_chunk"] == expected, (launches, expected)
    return launches


# ------------------------------------------------------------ telemetry ---
# check_probes: each wrapper's probe at its main-path shape (K1 the CNN
# cell's cut activations, K2 gemma3's global layer, K3 xlstm's serving
# shape, K4 recurrentgemma's)
PROBE_KERNELS = ("quantize", "flash_attention", "mlstm_chunk", "rglru_scan")
# genie: the Genie baseline's small card-against-CPU config (phase_reference's
# CNN and data), 2 epochs at batch 8; test_torch_fedsim.py's no-codec
# tolerance on the loss and the parameters, the same accuracy
GENIE_SMALL = dict(epochs=2, batch_size=8, learning_rate=0.05)
GENIE_TOL = dict(rtol=1e-4, atol=1e-5)


def _probe_calls(torch, fa_ops, ml_ops, ops, rg_ops):
    """Each probed wrapper's call at its main-path shape, on fixed inputs
    (K1's uniforms from a generator re-seeded on every call)."""
    x = torch.randn(MAIN_SHAPE, generator=torch.Generator(
        device="cuda").manual_seed(11), device="cuda")
    m = FLASH_MAIN
    fa = _flash_inputs(torch, m["b"], m["s"], m["h"], m["kvh"], m["d"],
                       torch.bfloat16, 12)
    m = MLSTM_MAIN
    ml = _mlstm_inputs(torch, m["b"], m["s"], m["h"], m["dh"],
                       torch.bfloat16, 13)
    m = RGLRU_MAIN
    rg = _rglru_inputs(torch, m["b"], m["s"], m["w"], torch.float32, 14)
    b, s, h, _, d = (FLASH_MAIN[k] for k in ("b", "s", "h", "kvh", "d"))
    mb, ms, mh, mdh = (MLSTM_MAIN[k] for k in ("b", "s", "h", "dh"))
    return {
        "quantize": (lambda: ops.quantize_rows(x, torch.Generator(
            device="cuda").manual_seed(5), bits=8), (x,),
            4.0 * x.numel()),
        "flash_attention": (lambda: fa_ops.flash_attention(
            *fa, causal=True, window=0), fa,
            4.0 * b * h * s * s * d * 0.5),
        "mlstm_chunk": (lambda: ml_ops.mlstm_chunk(*ml), ml,
                        2.0 * mb * mh * ms * ms * mdh),
        "rglru_scan": (lambda: rg_ops.rglru_scan(*rg), rg,
                       3.0 * rg[0].numel()),
    }


def phase_check_probes(torch, kernels, fa_ops, ml_ops, ops, rg_ops,
                       event_ms_of):
    """The telemetry probe of each kernel wrapper (``kernel.<name>.*``) at
    its main-path shape with a MetricsRegistry sink: one call, counted
    once and equal to the kernel's launches over the call; the reference's
    FLOP formula; the operands' and output's bytes; one wall time; and the
    output bit-equal to the same call with no sink.  The probed wall time
    (the wrapper's stream time: an event pair from wrapper entry to its
    return, K1's scale and uniforms included, resolved by
    ``telemetry.spans.resolve`` before the snapshot) beside the unprobed
    CUDA-event time of the time* phases."""
    from repro_torch.telemetry import MetricsRegistry, set_kernel_sink, spans
    calls = _probe_calls(torch, fa_ops, ml_ops, ops, rg_ops)
    rows = {}
    for name in PROBE_KERNELS:
        fn, operands, flops = calls[name]
        base = fn()
        torch.cuda.synchronize()
        reg = MetricsRegistry()
        before = read_counts(kernels)
        set_kernel_sink(reg)
        try:
            out = fn()
        finally:
            set_kernel_sink(None)
        spans.resolve()                    # the probe's event pair
        after = read_counts(kernels)
        delta = {k: after[k] - before[k] for k in after}
        snap = reg.snapshot()
        k = f"kernel.{name}"
        nbytes = float(sum(t.nbytes for t in operands) + out.nbytes)
        row = {"calls": snap[f"{k}.calls"]["value"],
               "launches": delta[name],
               "other_launches": {n: v for n, v in delta.items()
                                  if n != name and v},
               "flops": snap[f"{k}.flops"]["value"], "flops_expected": flops,
               "bytes": snap[f"{k}.bytes"]["value"],
               "bytes_expected": nbytes,
               "wall_s_count": snap[f"{k}.wall_s"]["count"],
               "probed_wall_ms": snap[f"{k}.wall_s"]["sum"] * 1e3,
               "event_ms": event_ms_of[name],
               "gflops_per_s": snap[f"{k}.gflops_per_s"]["value"],
               "bit_equal_to_unprobed": bool(torch.equal(out, base))}
        rows[name] = row
        del base, out
    emit({"phase": "check_probes", "kernels": rows,
          "event_ms_note": "quantize's event time is the kernel call alone "
                           "(quantize_dequantize); the probe wraps the "
                           "codec entry quantize_rows (scale, uniforms, "
                           "kernel)"})
    for name, row in rows.items():
        assert row["calls"] == 1 == row["launches"], (name, row)
        assert not row["other_launches"], (name, row)
        assert row["flops"] == row["flops_expected"], (name, row)
        assert row["bytes"] == row["bytes_expected"], (name, row)
        assert row["wall_s_count"] == 1, (name, row)
        assert row["bit_equal_to_unprobed"], (name, row)
    return rows


def _history_diff(np, a, b) -> float:
    """Largest absolute difference of two histories' float entries."""
    return max(abs(x[k] - y[k]) for x, y in zip(a, b) for k in x
               if isinstance(x[k], float))


def _stale_greedy_network(deadline):
    from repro_torch.models import cnn
    return dict(COHORT_BENCH_CHANNEL, cut_policy="greedy",
                cut_candidates=cnn.CUT_CANDIDATES, deadline_s=deadline,
                staleness_lambda=0.5)


def _stale_greedy_sim(data, deadline, telemetry=None):
    """fedsim_wireless's stale_greedy cell: the CNN at full width, 4 ESs x
    25 clients, int8 on all links, greedy cuts, lambda 0.5, ``deadline``;
    ``telemetry`` off by default."""
    FedSim, CNNConfig, H, T, _, link_codecs = _fedsim_parts()
    return FedSim(CNNConfig(), data,
                  H(num_edge_servers=4, clients_per_es=25, kappa0=5,
                    kappa1=3),
                  T(batch_size=32, finetune_steps=10), batches_per_epoch=5,
                  seed=0, codecs=link_codecs("int8"),
                  wireless=_wireless_config(_stale_greedy_network(deadline)),
                  telemetry=telemetry)


def _params_sum(res) -> float:
    return float(sum(x.double().sum() for p in res.global_params.values()
                     for x in p.values()))


def _rounds_of(sim, rounds):
    """Run ``sim`` to each round of ``rounds`` in turn: its network rows,
    the last history row of each, and the last result."""
    rows, hist = [], []
    for r in rounds:
        res = sim.run(rounds=r, log_every=1)
        rows += res.network
        hist.append(res.history[-1])
    return rows, hist, res


def _determinism_diagnostic(torch, data, deadline) -> list:
    """One round of the stale_greedy cell under
    ``torch.use_deterministic_algorithms(True, warn_only=True)``: the
    first line of each warning it gives, which names an op with no
    deterministic variant (the process-wide setting is restored after)."""
    import warnings
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            _stale_greedy_sim(data, deadline).run(rounds=1, log_every=1)
    finally:
        torch.use_deterministic_algorithms(False)
    return sorted({str(w.message).splitlines()[0][:240] for w in caught})


def phase_fedsim_repeat(torch, np, data, wireless):
    """F3: the CNN path repeats run to run on the card.  fedsim_wireless's
    stale_greedy cell, telemetry off, run again whole (2 rounds): its
    network rows, clock, history and the sum of its global parameters
    bit-equal to fedsim_wireless's run; then a run killed after round 1
    (``save``), restored into a new FedSim (``restore``) and run to round
    2: the same, bit for bit.  On any difference, one round under
    ``torch.use_deterministic_algorithms(True, warn_only=True)`` names
    the ops without a deterministic variant before the phase fails."""
    off = wireless["runs"]["stale_greedy"]
    deadline = wireless["deadline"]
    whole = {"rows": off["network"], "history": off["history"],
             "sim_time_s": off["sim_time_s"],
             "params_sum": off["params_sum"]}
    runs, walls = {}, {}
    t0 = time.perf_counter()
    rows, hist, res = _rounds_of(_stale_greedy_sim(data, deadline), (1, 2))
    runs["again"] = {"rows": rows, "history": hist,
                     "sim_time_s": res.total_sim_time_s,
                     "params_sum": _params_sum(res)}
    walls["again"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        first = _stale_greedy_sim(data, deadline)
        rows1, hist1, _ = _rounds_of(first, (1,))
        first.save(d)
        del first
        second = _stale_greedy_sim(data, deadline)
        restored = second.restore(d)
        rows2, hist2, res = _rounds_of(second, (2,))
        del second
    runs["resumed"] = {"rows": rows1 + rows2, "history": hist1 + hist2,
                       "sim_time_s": res.total_sim_time_s,
                       "params_sum": _params_sum(res)}
    walls["resumed"] = time.perf_counter() - t0
    equal = {name: {k: run[k] == whole[k] for k in whole}
             for name, run in runs.items()}
    spread = {name: {"history_max_abs_diff": _history_diff(
                         np, run["history"], whole["history"]),
                     "params_sum_abs_diff": abs(run["params_sum"]
                                                - whole["params_sum"])}
              for name, run in runs.items()}
    ok = all(all(v.values()) for v in equal.values()) and restored == 1
    diagnostic = None if ok else _determinism_diagnostic(torch, data,
                                                         deadline)
    emit({"phase": "fedsim_repeat", "cell": "fedsim_wireless stale_greedy",
          "rounds": 2,
          "cudnn_deterministic": torch.backends.cudnn.deterministic,
          "cudnn_benchmark": torch.backends.cudnn.benchmark,
          "bit_equal": equal, "spread": spread, "restored_step": restored,
          "wall_s": walls,
          "deterministic_algorithms_warnings": diagnostic})
    assert ok, (equal, spread, diagnostic)


def phase_fedsim_telemetry(torch, np, kernels, data, wireless):
    """``fedsim_wireless``'s stale_greedy run (the CNN at full width, 4 ESs
    x 25 clients, int8 on all links, greedy cuts, lambda 0.5, the same
    deadline), 2 global rounds under ``Telemetry(dir, kernels=True)``.
    The streamed trace against the scheduler's timeline of the last round
    (exact floats), the instruments against the network rows, K1's probe
    calls against its launches, the files; the rows, the clock and the
    history against fedsim_wireless's run with telemetry off, bit for bit
    (the card's CNN path repeats since F3's repair: fedsim_repeat)."""
    from repro_torch.models import cnn
    from repro_torch.telemetry import Telemetry
    network = _stale_greedy_network(wireless["deadline"])
    off = wireless["runs"]["stale_greedy"]

    def run(telemetry):
        sim = _stale_greedy_sim(data, wireless["deadline"], telemetry)
        sched, steps = sim.scheduler, []
        step = sched.step

        def recorded(r):
            t0 = telemetry.trace.clock_s
            rep = step(r)
            steps.append((t0, rep, sched.last_timeline))
            return rep

        sched.step = recorded
        rows, hist, walls = [], [], []
        for r in (1, 2):
            res, dt = sync_time(torch, lambda: sim.run(rounds=r, log_every=1))
            rows += res.network
            hist.append(res.history[-1])
            walls.append(dt)
        return (rows, hist, walls, res.total_sim_time_s, _params_sum(res),
                steps, sim)

    with tempfile.TemporaryDirectory() as d:
        tel = Telemetry(d, kernels=True)
        reset_counts(kernels)              # count this path's run alone
        rows, hist, walls, sim_time, psum, steps, sim = run(tel)
        counts = read_counts(kernels)
        tel.write_manifest(config=network, seeds={"seed": 0},
                           extra={"cell": "fedsim_wireless stale_greedy"})
        tel.close()
        files = sorted(os.listdir(d))
        evs = json.load(open(os.path.join(d, "trace.json")))
        lines = [json.loads(ln)
                 for ln in open(os.path.join(d, "metrics.jsonl"))]
        man = json.load(open(os.path.join(d, "manifest.json")))
    snap = lines[-1]["metrics"]
    launches = counts["quantize"]
    # fedsim_wireless's count for its 2 stale_greedy rounds: 2 x (2 x 75 +
    # 3 x 2) = 312 at the cell's config
    h, bpe = sim.h, sim.batches_per_epoch
    del sim
    n_offload = len(cnn.client_keys_for(cnn.DEFAULT_CUT)) * 2
    steps_ = h.kappa0 * h.kappa1 * bpe
    expected = 2 * (2 * steps_ + h.kappa1 * n_offload)
    # the trace's client segments of the last round against its timeline
    t0, rep, tl = steps[-1]
    r = int(rep.round_idx)
    mine = [e for e in evs if e.get("ph") == "X" and e["pid"] == 1
            and e["args"]["round"] == r]
    seg_bad, n_seg = [], 0
    for u in np.flatnonzero(rep.scheduled):
        got = sorted((e["name"], e["ts"], e["dur"]) for e in mine
                     if e["tid"] == u)
        want = []
        for kind, s_arr, e_arr in (("compute", tl.comp_start[u],
                                    tl.comp_end[u]),
                                   ("uplink", tl.tx_start[u], tl.tx_end[u])):
            for i, (s, e) in enumerate(zip(s_arr, e_arr)):
                if kind == "uplink" and tl.tx_bits[u, i] <= 0 \
                        and len(s_arr) > 1:
                    continue
                if math.isfinite(s) and math.isfinite(e):
                    name = kind if len(s_arr) == 1 else f"{kind}[{i}]"
                    want.append((name, (t0 + float(s)) * 1e6,
                                 float(e - s) * 1e6))
        s, e = float(tl.down_start[u]), float(tl.down_end[u])
        if math.isfinite(s) and math.isfinite(e):
            want.append(("downlink", (t0 + s) * 1e6, (e - s) * 1e6))
        n_seg += len(want)
        if got != sorted(want):
            seg_bad.append(int(u))
    client_tracks = {e["tid"] for e in evs
                     if e["ph"] == "M" and e["pid"] == 1 and "tid" in e}
    scheduled = set(int(u) for _, rp, _ in steps
                    for u in np.flatnonzero(rp.scheduled))
    es_tracks = {e["tid"] for e in evs
                 if e["ph"] == "M" and e["pid"] == 2 and "tid" in e}
    history_equal = hist == off["history"]
    emit({"phase": "fedsim_telemetry", "files": files,
          "trace_events": len(evs), "client_tracks": len(client_tracks),
          "scheduled_clients": len(scheduled), "es_tracks": sorted(es_tracks),
          "last_round_segments": n_seg, "segment_mismatch_clients": seg_bad,
          "sched_participants": snap["sched.participants"]["value"],
          "rows_participants": sum(x["participants"] for x in rows),
          "fedsim_rounds": snap["fedsim.rounds"]["value"],
          "agg_mass_live": snap["fedsim.agg_mass_live"]["value"],
          "agg_mass_stale": snap.get("fedsim.agg_mass_stale", {}).get(
              "value"),
          "quantize_probe_calls": snap["kernel.quantize.calls"]["value"],
          "quantize_launches": launches, "launches": counts,
          "quantize_launches_expected": expected,
          "quantize_probe_wall_s_sum": snap["kernel.quantize.wall_s"]["sum"],
          "fedsim_round_wall_s": snap["fedsim.round_wall_s"]["sum"],
          "manifest_device_kind": man["torch"]["device_kind"],
          "rows_equal": rows == off["network"],
          "sim_time_equal": sim_time == off["sim_time_s"],
          "history_equal": history_equal,
          "params_sum_equal": psum == off["params_sum"],
          "on_vs_off_history_max_abs_diff": _history_diff(
              np, hist, off["history"]),
          "round_wall_s_telemetry": walls,
          "round_wall_s_fedsim_wireless": off["walls"]})
    assert files == ["manifest.json", "metrics.jsonl", "spans.json",
                     "summary.txt", "trace.json"], files
    assert client_tracks == scheduled and len(es_tracks) == 4, (
        client_tracks, scheduled, es_tracks)
    assert n_seg > 0 and not seg_bad, seg_bad
    assert snap["sched.participants"]["value"] == sum(
        x["participants"] for x in rows)
    assert snap["fedsim.rounds"]["value"] == 2
    assert snap["kernel.quantize.calls"]["value"] == launches == expected, (
        snap["kernel.quantize.calls"], launches, expected)
    assert man["torch"]["device_kind"] == torch.cuda.get_device_name()
    assert rows == off["network"] and sim_time == off["sim_time_s"]
    assert history_equal and psum == off["params_sum"], (hist, psum, off)
    return counts


def phase_train_telemetry(torch, np, kernels):
    """``launch/train.py``'s ``main`` with train_wireless's flags and
    ``--trace-dir`` on the card: the final JSON and losses equal to the
    same ``main`` without it, K3's probe calls equal to its launches, the
    four files, and the log's ``log.train.*`` gauges."""
    import io
    from repro_torch.configs.base import MLSTM
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch.train import main, parse_args
    args = parse_args(TRAIN_WIRELESS_FLAGS)
    n_mlstm = sum(k == MLSTM for k in get_arch(args.arch).reduced()
                  .layer_kinds())
    expected = _train_forwards(dict(rounds=args.rounds, clients=args.clients,
                                    local_steps=args.local_steps)) * n_mlstm
    flags = ["--device", "cuda", *TRAIN_WIRELESS_FLAGS]
    outs = {}
    with tempfile.TemporaryDirectory() as d:
        for name, extra in (("on", ["--trace-dir", f"{d}/trace"]),
                            ("off", [])):
            buf = io.StringIO()
            reset_counts(kernels)
            with contextlib.redirect_stdout(buf):
                res, dt = sync_time(torch, lambda: main(flags + extra))
            outs[name] = (json.loads(buf.getvalue().strip().splitlines()[-1]),
                          res.losses, dt, read_counts(kernels))
        files = sorted(os.listdir(f"{d}/trace"))
        lines = [json.loads(ln) for ln in open(f"{d}/trace/metrics.jsonl")]
    snap = lines[-1]["metrics"]
    logs = sorted(k for k in snap if k.startswith("log.train."))
    (on, on_losses, on_s, counts), (off, off_losses, off_s, _) = (
        outs["on"], outs["off"])
    on_launch = counts["mlstm_chunk"]
    emit({"phase": "train_telemetry", "flags": TRAIN_WIRELESS_FLAGS,
          "final_on": on, "final_off": off, "final_equal": on == off,
          "losses_equal": on_losses == off_losses,
          "mlstm_probe_calls": snap["kernel.mlstm_chunk.calls"]["value"],
          "mlstm_launches": on_launch, "launches": counts,
          "mlstm_launches_expected": expected, "files": files,
          "log_gauges": logs, "metrics_lines": len(lines),
          "main_s_on": on_s, "main_s_off": off_s})
    assert on == off and on_losses == off_losses, (on, off)
    assert snap["kernel.mlstm_chunk.calls"]["value"] == on_launch \
        == expected, (snap["kernel.mlstm_chunk.calls"], on_launch, expected)
    assert files == ["manifest.json", "metrics.jsonl", "spans.json",
                     "summary.txt", "trace.json"], files
    assert "log.train.loss" in logs and "log.train.participants" in logs
    return counts


def phase_genie(torch, np, data):
    """The paper's Genie baseline (``centralized_sgd``): SGD over the
    pooled data of the CNN cell's 100 clients at ``CNNConfig()``, batch
    32, one epoch, on the card: loss and accuracy finite, accuracy above
    chance.  Then phase_reference's small CNN and data, card against CPU:
    the loss and the parameters within test_torch_fedsim.py's no-codec
    tolerance, the same accuracy."""
    _, CNNConfig, _, T, make_data, _ = _fedsim_parts()
    from repro_torch.core.fedsim import centralized_sgd
    (params, full), secs = sync_time(torch, lambda: centralized_sgd(
        CNNConfig(), data, T(batch_size=32), epochs=1, seed=0))
    n_train = int(len(data.dataset.y_train))
    classes = int(data.dataset.y_test.max()) + 1
    small_cfg = CNNConfig(image_size=16, conv1_filters=8, conv2_filters=16,
                          fc_hidden=32)
    small = make_data(4, 0.5, image_size=16, train_per_class=30,
                      test_per_class=10, seed=0)
    tc = T(learning_rate=GENIE_SMALL["learning_rate"],
           batch_size=GENIE_SMALL["batch_size"])
    runs = {dev: centralized_sgd(small_cfg, small, tc,
                                 epochs=GENIE_SMALL["epochs"], seed=0,
                                 device=dev) for dev in ("cuda", "cpu")}
    (pc, mc), (pp, mp) = runs["cuda"], runs["cpu"]
    diff = abs(mc["loss"] - mp["loss"])
    for k in pp:
        for n in pp[k]:
            x, y = pc[k][n].cpu().numpy(), pp[k][n].numpy()
            np.testing.assert_allclose(x, y, **GENIE_TOL, err_msg=f"{k}/{n}")
            diff = max(diff, float(np.abs(x - y).max()))
    emit({"phase": "genie", "config": {
              "model": "CNNConfig()", "train_images": n_train,
              "batch": 32, "epochs": 1, "steps": n_train // 32,
              "lr": T().learning_rate},
          "acc": full["acc"], "loss": full["loss"], "seconds": secs,
          "steps_per_s": (n_train // 32) / secs, "chance": 1.0 / classes,
          "small_cuda": mc, "small_cpu": mp, "small_max_abs_diff": diff,
          "tol": GENIE_TOL})
    assert math.isfinite(full["loss"]) and math.isfinite(full["acc"])
    assert full["acc"] > 1.0 / classes, full
    np.testing.assert_allclose(mc["loss"], mp["loss"], **GENIE_TOL)
    assert mc["acc"] == mp["acc"], (mc, mp)


# ------------------------------------------- the MoE / MLA / M-RoPE zoo ----
def attention_layers(cfg) -> int:
    """Layers of ``cfg`` that launch K2 once a trunk forward: global,
    sliding-window and MLA attention (decoding is dense tensor code over
    the cache, and MLA decodes in its latent form); in the
    encoder-decoder every encoder layer and every decoder layer's
    self-attention (its cross-attention takes the dense path)."""
    from repro_torch.configs.base import ATTN, LOCAL_ATTN, MLA_ATTN
    if cfg.encdec is not None:
        return cfg.encdec.num_encoder_layers + cfg.num_layers
    return sum(kind in (ATTN, LOCAL_ATTN, MLA_ATTN)
               for kind in cfg.layer_kinds())


def serve_launches(cfg) -> int:
    """K2 launches of one ``serve()``: the head bank's trunk forward, and
    for the encoder-decoder the ``encode`` that fills the decode cache's
    cross half."""
    return attention_layers(cfg) + (cfg.encdec.num_encoder_layers
                                    if cfg.encdec is not None else 0)


def zoo_config(arch, **over):
    """An architecture of the zoo slice, its MoE widened past top_k =
    experts when reduced (as the CPU parity tests widen it)."""
    from repro_torch.configs.registry import get_arch
    cfg = get_arch(arch).reduced(**over)
    if arch in ZOO_WIDENED:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, **ZOO_WIDENED[arch]))
    return cfg


def phase_reference_zoo(torch, np, kernels):
    """Each of the six architectures of the slice at ``reduced(num_layers=
    3)`` (float32, olmoe's and deepseek's MoE widened to 8 experts, top-2
    and top-3) on the card against the CPU, same weights: the loss (with
    the MoE auxiliary term; qwen2-vl with its patch embeddings and M-RoPE
    positions), the logits of a few decode steps (qwen2-vl's with M-RoPE
    ids) and a short ``serve()`` (head bank, logits, tokens), within
    ZOO_TOL, the CPU tests' 1e-4.  K2 launches once per attention layer
    a forward on the card (counts read around each architecture)."""
    from repro_torch.launch.serve import serve
    from repro_torch.models.registry import build_model
    from repro_torch.telemetry import MetricLogger
    from repro_torch.utils.prng import make_generator
    from repro_torch.utils.tree import tree_map
    rows = {}
    for arch in ZOO_ARCHS:
        cfg = zoo_config(arch, num_layers=ZOO_REFERENCE_LAYERS)
        model = build_model(cfg)
        params = model.init(make_generator(0, "cpu"))
        card = tree_map(lambda t: t.cuda(), params)
        r = np.random.default_rng(1)
        toks = r.integers(0, cfg.vocab_size, (2, 64)).astype(np.int32)
        batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
        if cfg.vlm is not None:
            batch["patch_embeds"] = (0.02 * r.normal(size=(
                2, cfg.vlm.num_patch_tokens, cfg.d_model))).astype(
                np.float32)
            batch["positions3"] = r.integers(0, 64, (2, 64, 3)).astype(
                np.int32)
        loss = {}
        for dev, p in (("cuda", card), ("cpu", params)):
            reset_counts(kernels)
            with torch.no_grad():
                loss[dev] = float(model.loss(
                    p, {k: torch.from_numpy(v).to(dev)
                        for k, v in batch.items()}))
            if dev == "cuda":
                counts = read_counts(kernels)
        steps = {}
        for dev, p in (("cuda", card), ("cpu", params)):
            cache = model.init_cache(2, 4, dtype=torch.float32, device=dev)
            out = []
            with torch.no_grad():
                for i in range(4):
                    kw = ({"positions3": torch.from_numpy(
                        batch["positions3"][:, i:i + 1]).to(dev)}
                          if cfg.vlm is not None else {})
                    lg, cache = model.decode_step(
                        p, torch.from_numpy(toks[:, i:i + 1]).to(dev),
                        cache, i, **kw)
                    out.append(lg.cpu().numpy())
            steps[dev] = np.stack(out)
        skw = dict(batch=4, steps=8, clients=3, prompt_len=8, seed=0,
                   bank_seq=64, log=MetricLogger("reference_zoo",
                                                 sys.stderr))
        sc = serve(cfg, params=card, device="cuda", **skw)
        sp = serve(cfg, params=params, device="cpu", **skw)
        diffs = {"loss": abs(loss["cuda"] - loss["cpu"]),
                 "decode_logits": float(np.abs(steps["cuda"]
                                               - steps["cpu"]).max())}
        np.testing.assert_allclose(loss["cuda"], loss["cpu"], rtol=ZOO_TOL,
                                   atol=ZOO_TOL, err_msg=arch)
        np.testing.assert_allclose(steps["cuda"], steps["cpu"], rtol=ZOO_TOL,
                                   atol=ZOO_TOL, err_msg=arch)
        for name in ("head_bank", "logits", "bank_losses"):
            a = getattr(sc, name).cpu().numpy()
            b = getattr(sp, name).numpy()
            assert np.isfinite(a).all(), (arch, name)
            np.testing.assert_allclose(a, b, rtol=ZOO_TOL, atol=ZOO_TOL,
                                       err_msg=f"{arch} {name}")
            diffs[f"serve_{name}"] = float(np.abs(a - b).max())
        same_tokens = sc.generated.cpu().tolist() == sp.generated.tolist()
        rows[arch] = {"layer_kinds": list(cfg.layer_kinds()),
                      "moe": dataclasses.asdict(cfg.moe) if cfg.moe else None,
                      "loss": loss, "cuda_vs_cpu_max_abs_diff": diffs,
                      "same_tokens": same_tokens,
                      "loss_launches": counts["flash_attention"],
                      "loss_launches_expected": attention_layers(cfg)}
        assert math.isfinite(loss["cuda"]), arch
        assert same_tokens, f"{arch}: generated tokens differ"
        assert counts["flash_attention"] == attention_layers(cfg) > 0, (
            arch, counts)
    emit({"phase": "reference_zoo", "tol": ZOO_TOL,
          "num_layers": ZOO_REFERENCE_LAYERS, "archs": rows})
    return rows


def _serve_zoo(torch, kernels, cfg, name):
    """serve() of ``cfg`` on the card at the serving cells' traffic,
    counts set to 0 just before and read just after, with the head width
    of every K2 launch and the MoE's host reads of its group sizes."""
    from repro_torch.hopper.flash_attention import kernel as fa_kernel
    from repro_torch.launch.serve import serve
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.registry import build_model
    from repro_torch.telemetry import MetricLogger
    from repro_torch.utils.prng import make_generator
    from repro_torch.utils.tree import tree_leaves
    model = build_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    params, init_s = sync_time(
        torch, lambda: model.init(make_generator(0, "cuda")))
    n_params = sum(t.numel() for t in tree_leaves(params))
    kw = SERVE_CELL
    widths = []
    launch = fa_kernel.flash_attention_cuda

    def seen(q, k, v, **a):
        widths.append((q.shape[-1], v.shape[-1]))
        return launch(q, k, v, **a)

    fa_kernel.flash_attention_cuda = seen
    reset_counts(kernels)                  # count this path's run alone
    moe_mod.group_size_reads = 0
    try:
        res, wall = sync_time(torch, lambda: serve(
            cfg, params=params, device="cuda",
            log=MetricLogger(name, sys.stderr), **kw))
    finally:
        fa_kernel.flash_attention_cuda = launch
    counts = read_counts(kernels)
    reads = moe_mod.group_size_reads
    peak = torch.cuda.max_memory_allocated()
    expected = serve_launches(cfg)
    finite = bool(torch.isfinite(res.logits).all()
                  and torch.isfinite(res.bank_losses).all()
                  and torch.isfinite(res.head_bank.float()).all())
    shapes_ok = (tuple(res.generated.shape) == (kw["batch"], kw["steps"])
                 and tuple(res.logits.shape) == (kw["batch"], kw["steps"],
                                                 cfg.padded_vocab)
                 and tuple(res.head_bank.shape) == (
                     kw["clients"], cfg.d_model, cfg.padded_vocab))
    tokens_ok = bool(((res.generated >= 0)
                      & (res.generated < cfg.vocab_size)).all())
    row = {"phase": name, "config": {
               "arch": cfg.name, "num_layers": cfg.num_layers,
               "layer_kinds": list(cfg.layer_kinds()),
               "d_model": cfg.d_model, "heads": cfg.num_heads,
               "kv_heads": cfg.num_kv_heads, "head_dim": cfg.head_dim,
               "moe": dataclasses.asdict(cfg.moe) if cfg.moe else None,
               "mla": dataclasses.asdict(cfg.mla) if cfg.mla else None,
               "encdec": (dataclasses.asdict(cfg.encdec) if cfg.encdec
                          else None),
               "vocab": cfg.padded_vocab, "dtype": cfg.dtype, **kw},
           "params": n_params, "init_s": init_s, "serve_wall_s": wall,
           "head_bank_s": res.bank_seconds, "decode_s": res.decode_seconds,
           "decode_tokens": res.tokens, "decode_tok_per_s": res.tok_per_s,
           "bank_losses": res.bank_losses.cpu().tolist(),
           "generated": res.generated.cpu().tolist(),
           "peak_mem_GB": peak / 1e9, "launches": counts,
           "flash_launches_expected": expected,
           "flash_head_widths_qv": sorted(set(widths)),
           "moe_group_size_reads": reads, "finite": finite,
           "shapes_ok": shapes_ok, "tokens_in_vocab": tokens_ok}
    assert finite, "non-finite logits or losses"
    assert shapes_ok and tokens_ok, "serve output has the wrong shape"
    assert counts["flash_attention"] == expected == len(widths) > 0, (
        counts, expected, len(widths))
    assert (counts["quantize"] == counts["mlstm_chunk"]
            == counts["rglru_scan"] == 0), counts
    return model, params, res, row


def _moe_profile(torch, cfg, model, params, res, name):
    """Where one trunk forward of the head bank's size goes (6 x 2048
    tokens): device kernel time of the whole forward, and of its MoE
    FFNs alone (run again on the inputs they got in that forward), so the
    MoE's share of the forward's kernel time; the host reads of the group
    sizes a forward and a decode step; one decode step's profile."""
    from repro_torch.launch.serve import personalized_logits
    from repro_torch.models import moe as moe_mod
    toks = torch.randint(0, cfg.vocab_size, (6, 2048), device="cuda")

    def forward():
        with torch.no_grad():
            model.apply(params, {"tokens": toks})

    captured = []
    apply_moe = moe_mod.moe_apply

    def grab(p, c, h, **a):
        captured.append((p, h))
        return apply_moe(p, c, h, **a)

    moe_mod.moe_apply = grab
    moe_mod.group_size_reads = 0
    try:
        forward()
    finally:
        moe_mod.moe_apply = apply_moe
    reads_forward = moe_mod.group_size_reads

    def moe_only():
        with torch.no_grad():
            for p, h in captured:
                apply_moe(p, cfg, h)

    row, _ = kernel_breakdown(torch, forward, 1)
    moe_row, _ = kernel_breakdown(torch, moe_only, 1)
    del captured
    kernel_ms = row["kernel_ms_sum_per_step"]
    emit({"phase": name, "what": f"one trunk forward, 6 x 2048 tokens, "
          f"{cfg.num_layers} layers, bf16", **row,
          "moe_kernel_ms": moe_row["kernel_ms_sum_per_step"],
          "moe_share_of_kernel_time": moe_row["kernel_ms_sum_per_step"]
          / kernel_ms if kernel_ms else None,
          "moe_alone_wall_ms": moe_row["wall_ms_per_step"],
          "moe_alone_busy_share": moe_row["device_busy_share"],
          "moe_top_kernels": moe_row["top_kernels"][:5],
          "group_size_reads_per_forward": reads_forward})

    kw = SERVE_CELL
    cache = model.init_cache(kw["batch"], kw["prompt_len"] + kw["steps"],
                             dtype=torch.float32, device="cuda")
    bank32 = res.head_bank.to(torch.float32)
    tok = res.generated[:, :1]

    def decode():
        with torch.no_grad():
            h, _ = model.decode_step(params, tok, cache, kw["prompt_len"],
                                     return_hidden=True)
            personalized_logits(h.to(torch.float32), bank32, res.profiles)

    decode()                               # warm-up outside the profile
    moe_mod.group_size_reads = 0
    decode()
    reads_step = moe_mod.group_size_reads
    row, _ = kernel_breakdown(torch, decode, 5)
    emit({"phase": name, "what": f"one decode step, batch {kw['batch']}, "
          f"{cfg.num_layers} layers, per-request float32 heads", **row,
          "group_size_reads_per_step": reads_step})
    return reads_forward, reads_step


def phase_serve_olmoe(torch, kernels):
    """The LM path at olmoe-1b-7b's published config whole (16 layers,
    d_model 2048, 16 heads of 128, 64 experts of 1024, top-8, vocab
    50304, bf16) at the serving cells' traffic (batch 4, 3 profiles,
    prompt 16, 16 tokens, the bank at 4 steps a client on 2 x 2048
    tokens): one K2 launch per attention layer (16) in the bank's
    forward, at head width 128; then where a trunk forward's kernel time
    goes (the MoE's share) and one decode step."""
    from repro_torch.configs.registry import get_arch
    cfg = get_arch("olmoe-1b-7b")
    model, params, res, row = _serve_zoo(torch, kernels, cfg, "serve_olmoe")
    n_moe = cfg.num_layers
    expected_reads = n_moe * (1 + SERVE_CELL["prompt_len"] - 1
                              + SERVE_CELL["steps"])
    row["moe_group_size_reads_expected"] = expected_reads
    emit(row)
    assert row["launches"]["flash_attention"] == 16, row["launches"]
    assert row["flash_head_widths_qv"] == [(128, 128)], row
    assert row["moe_group_size_reads"] == expected_reads, row
    reads = _moe_profile(torch, cfg, model, params, res,
                         "serve_profile_olmoe")
    assert reads == (n_moe, n_moe), reads
    return row


def phase_serve_deepseek(torch, kernels):
    """The LM path at deepseek-v2-236b's published widths (d_model 5120,
    128 MLA heads of 128 + 64 over a 512-wide latent, v 128, 160 routed
    experts of 1536, top-6, plus 2 shared, vocab 102400, bf16), cut to
    DEEPSEEK_LAYERS layers: the first dense layer (d_ff 12288), then MoE
    layers.  The serving cells' traffic; one K2 launch per layer at head
    width 192 (v zero-padded from 128); the latent cache's bytes per
    token and layer against an expanded KV cache's."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.utils.tree import tree_leaves
    cfg = dataclasses.replace(get_arch("deepseek-v2-236b"),
                              num_layers=DEEPSEEK_LAYERS)
    model, params, res, row = _serve_zoo(torch, kernels, cfg,
                                         "serve_deepseek")
    m = cfg.mla
    f32 = 4                                      # serve() caches in float32
    latent = (m.kv_lora_rank + m.qk_rope_head_dim) * f32
    expanded = cfg.num_heads * (m.qk_nope_head_dim + m.qk_rope_head_dim
                                + m.v_head_dim) * f32
    cache = model.init_cache(1, 1, dtype=torch.float32, device="meta")
    measured = sum(t.numel() * t.element_size()
                   for t in tree_leaves(cache)) // cfg.num_layers
    row.update(latent_cache_bytes_per_token_layer=measured,
               latent_cache_bytes_formula=latent,
               expanded_kv_bytes_per_token_layer=expanded,
               expanded_over_latent=expanded / latent)
    emit(row)
    assert measured == latent == 2304, (measured, latent)
    assert row["launches"]["flash_attention"] == DEEPSEEK_LAYERS, row
    assert row["flash_head_widths_qv"] == [(192, 192)], row
    return row


def phase_train_zoo(torch, kernels, arch, name):
    """PHSFL training at ``arch``'s published widths cut to
    TRAIN_ZOO_LAYERS layers, bf16, through train(): 2 clients in one ES,
    one round of one local step on 1 x 2048 tokens (qwen2-vl's first
    1024 the launcher's patch embeddings, with its M-RoPE positions;
    olmoe's loss with the router's auxiliary term), then the head bank
    and both evaluations.  Counts set to 0 just before and read just
    after: K2 once per attention layer a forward, under autograd in the
    local steps.  Fails on a non-finite loss, a head leaf that moved or
    clients that differ after the edge step."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch.train import train
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.registry import build_model
    from repro_torch.telemetry import MetricLogger
    from repro_torch.utils.prng import make_generator
    from repro_torch.utils.tree import tree_leaves
    cfg = dataclasses.replace(get_arch(arch), num_layers=TRAIN_ZOO_LAYERS)
    kw = TRAIN_ZOO
    model = build_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    params = model.init(make_generator(kw["seed"], "cuda"))
    head0 = params["lm_head"]["w"].clone()
    n_params = sum(t.numel() for t in tree_leaves(params))
    reset_counts(kernels)                  # count this path's run alone
    moe_mod.group_size_reads = 0
    res, wall = sync_time(torch, lambda: train(
        cfg, params=params, device="cuda",
        log=MetricLogger(name, sys.stderr), **kw))
    del params
    counts = read_counts(kernels)
    expected = _train_forwards(kw) * attention_layers(cfg)
    finite = (all(math.isfinite(v) for v in res.losses)
              and bool(torch.isfinite(res.global_eval).all()
                       and torch.isfinite(res.personalized_eval).all()
                       and torch.isfinite(res.finetune_losses).all()))
    frozen = _heads_frozen(torch, res.params, head0)
    synced = _replicas_equal(torch, res.params)
    emit({"phase": name, "config": {
              "arch": cfg.name, "num_layers": cfg.num_layers,
              "layer_kinds": list(cfg.layer_kinds()),
              "d_model": cfg.d_model, "heads": cfg.num_heads,
              "kv_heads": cfg.num_kv_heads, "vocab": cfg.padded_vocab,
              "moe": dataclasses.asdict(cfg.moe) if cfg.moe else None,
              "vlm": dataclasses.asdict(cfg.vlm) if cfg.vlm else None,
              "dtype": cfg.dtype, "edge_servers": 1, **kw},
          "params": n_params, "train_wall_s": wall,
          "round_wall_s": res.round_seconds,
          "tokens_per_round": res.tokens_per_round,
          "train_tokens_per_s": res.tokens_per_s,
          "peak_mem_GB": res.peak_mem_GB, "losses": res.losses,
          "finetune_losses": res.finetune_losses.cpu().tolist(),
          "global_eval": res.global_eval.cpu().tolist(),
          "personalized_eval": res.personalized_eval.cpu().tolist(),
          "personalization_gain": res.personalization_gain,
          "launches": counts, "flash_launches_expected": expected,
          "flash_launches_expected_from": "(rounds x clients x kappa0 "
          "local-step forwards + head bank + 2 evals) x attention layers",
          "moe_group_size_reads": moe_mod.group_size_reads,
          "finite": finite, "head_frozen": frozen, "clients_equal": synced})
    assert finite, "non-finite loss"
    assert frozen, "a head leaf moved"
    assert synced, "clients differ after the edge step"
    assert counts["flash_attention"] == expected > 0, (counts, expected)
    assert (counts["quantize"] == counts["mlstm_chunk"]
            == counts["rglru_scan"] == 0), counts
    return counts


# ------------------------------------------- encoder-decoder and remat ----
def _loss_grads(torch, model, params, batch, dev, **kw):
    """The loss and every gradient (numpy, in path order) of one batch on
    ``dev``, with the model's remat keywords ``kw``."""
    from repro_torch.utils.tree import tree_leaves, tree_map
    leaves = tree_map(lambda t: t.clone().requires_grad_(), params)
    loss = model.loss(leaves, {k: torch.from_numpy(v).to(dev)
                               for k, v in batch.items()}, **kw)
    grads = torch.autograd.grad(loss, tree_leaves(leaves))
    return float(loss.detach()), [g.cpu().numpy() for g in grads]


def phase_reference_encdec(torch, np, kernels):
    """seamless-m4t-medium at ``reduced()`` (2 encoder and 2 decoder
    layers, d_model 256, 4 heads of 64, 32 source frames, float32) on the
    card against the CPU, same weights: the loss and every gradient with
    ``remat`` off, under "full" and under "dots" (K2 once per encoder
    and decoder layer a forward, twice under remat: the backward's
    recompute), each within ENCDEC_TOL, the CPU tests' 1e-5; whether the
    card's remat gradients equal its plain ones bit for bit; then a
    12-step greedy decode from ``encode`` + ``precompute_cross`` over the
    same frames: the same tokens, the logits within 1e-5."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.models import encdec
    from repro_torch.models.registry import build_model
    from repro_torch.utils.prng import make_generator
    from repro_torch.utils.tree import tree_map
    cfg = get_arch("seamless-m4t-medium").reduced()
    model = build_model(cfg)
    params = model.init(make_generator(0, "cpu"))
    card = tree_map(lambda t: t.cuda(), params)
    r = np.random.default_rng(1)
    toks = r.integers(0, cfg.vocab_size, (2, 64)).astype(np.int32)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1),
             "source_embeds": (0.02 * r.normal(size=(
                 2, cfg.encdec.max_source_len, cfg.d_model))).astype(
                 np.float32)}
    rows, card_grads = {}, {}
    for name, kw in REMAT_POLICIES.items():
        reset_counts(kernels)
        loss_c, grads_c = _loss_grads(torch, model, card, batch, "cuda",
                                      **kw)
        counts = read_counts(kernels)
        loss_h, grads_h = _loss_grads(torch, model, params, batch, "cpu",
                                      **kw)
        expected = attention_layers(cfg) * (2 if kw else 1)
        rows[name] = {
            "loss_card": loss_c, "loss_cpu": loss_h,
            "loss_abs_diff": abs(loss_c - loss_h),
            "grad_max_abs_diff": max(float(np.abs(a - b).max())
                                     for a, b in zip(grads_c, grads_h)),
            "flash_launches": counts["flash_attention"],
            "flash_launches_expected": expected}
        card_grads[name] = grads_c
        np.testing.assert_allclose(loss_c, loss_h, rtol=ENCDEC_TOL,
                                   atol=ENCDEC_TOL, err_msg=name)
        for a, b in zip(grads_c, grads_h):
            np.testing.assert_allclose(a, b, rtol=ENCDEC_TOL,
                                       atol=ENCDEC_TOL, err_msg=name)
        assert counts["flash_attention"] == expected, (name, counts)
    for name in ("full", "dots"):
        rows[name]["card_grads_bit_equal_to_none"] = all(
            np.array_equal(a, b)
            for a, b in zip(card_grads[name], card_grads["none"]))
    logits, tokens = {}, {}
    for dev, p in (("cuda", card), ("cpu", params)):
        cache = model.init_cache(2, ENCDEC_STEPS, dtype=torch.float32,
                                 device=dev)
        out, gen = [], []
        with torch.no_grad():
            src = torch.from_numpy(batch["source_embeds"]).to(dev)
            cache["cross"] = encdec.precompute_cross(
                p, cfg, encdec.encode(p, cfg, src), dtype=torch.float32)
            tok = torch.from_numpy(toks[:, :1]).to(dev)
            for i in range(ENCDEC_STEPS):
                lg, cache = model.decode_step(p, tok, cache, i)
                out.append(lg.cpu().numpy())
                tok = lg[..., :cfg.vocab_size].argmax(-1).to(torch.int32)
                gen.append(tok.cpu().numpy())
        logits[dev], tokens[dev] = np.stack(out), np.stack(gen)
    same_tokens = np.array_equal(tokens["cuda"], tokens["cpu"])
    decode_diff = float(np.abs(logits["cuda"] - logits["cpu"]).max())
    emit({"phase": "reference_encdec", "config": cfg.name,
          "dtype": cfg.dtype, "tol": ENCDEC_TOL, "policies": rows,
          "decode_steps": ENCDEC_STEPS, "decode_same_tokens": same_tokens,
          "decode_logits_max_abs_diff": decode_diff})
    assert same_tokens, "decoded tokens differ"
    np.testing.assert_allclose(logits["cuda"], logits["cpu"],
                               rtol=ENCDEC_TOL, atol=ENCDEC_TOL)
    return {name: row["flash_launches"] for name, row in rows.items()}


def phase_serve_seamless(torch, kernels):
    """The LM path at seamless-m4t-medium's published config whole (12
    encoder and 12 decoder layers, d_model 1024, 16 heads of 64, d_ff
    4096, vocab 256206 padded to 256256, bf16, about 0.98 B parameters)
    at the serving cells' traffic (batch 4, 3 profiles, prompt 16, 16
    tokens, the bank 4 steps a client on 2 x 2048 decoder tokens over
    1024 source frames of 0.02), counts set to 0 just before and read
    just after: K2 24 times in the bank's trunk pass (every encoder and
    decoder self-attention layer) and 12 in the ``encode`` that fills the
    decode cache's cross half, all at head width 64."""
    from repro_torch.configs.registry import get_arch
    cfg = get_arch("seamless-m4t-medium")
    _, _, _, row = _serve_zoo(torch, kernels, cfg, "serve_seamless")
    row["flash_launches_expected_from"] = (
        "bank trunk pass: encoder + decoder layers; encode for the cross "
        "cache: encoder layers")
    emit(row)
    assert row["launches"]["flash_attention"] == 24 + 12, row["launches"]
    assert row["flash_head_widths_qv"] == [(64, 64)], row
    return row


def phase_train_seamless(torch, kernels):
    """PHSFL training of seamless-m4t-medium whole (bf16, about 0.98 B
    parameters): 2 clients in one ES, one local step each on 1 x 2048
    decoder tokens over 1024 source frames of 0.02, one round through
    ``make_host_round``, three times from the same parameters and batch:
    without remat, under the reference's default ``TrainConfig`` (remat
    "full") and under "dots".  Then each round's global model's head bank
    (Eq. 18, the default 10 steps at 0.01) and both evaluations on the
    seed-777 batch.  Per round: wall time and tokens/s; peak memory (reset
    before the round) and the peak above what was allocated before it; K2
    launches against the count reckoned for the policy (once per encoder
    and decoder layer a local step's forward, twice under remat: the
    backward's recompute; the bank's trunk pass and the two evaluations
    once each); the params after the round against the round without
    remat within the host round's tolerance (bit-equality reported); the
    head bit for bit, the clients equal, a positive personalization
    gain.  The round's peak is its edge step's, whatever the policy, so
    one local step on client 0's batch is timed and its peak read apart,
    and what one micro-batch's forward keeps for the backward (the bytes
    still allocated after its loss): what the policy saves."""
    from repro_torch.configs.base import HierarchyConfig, TrainConfig
    from repro_torch.configs.registry import get_arch
    from repro_torch.core.personalize import (personalize_head_bank,
                                              personalized_eval)
    from repro_torch.core.phsfl import (build_optimizer, local_steps,
                                        make_host_round, stack_replicas)
    from repro_torch.launch.train import _client_round_batch
    from repro_torch.models.registry import build_model
    from repro_torch.utils.prng import make_generator
    from repro_torch.utils.tree import path_leaves, tree_leaves, tree_map
    cfg = get_arch("seamless-m4t-medium")
    kw = TRAIN_SEAMLESS
    C, k = kw["clients"], kw["local_steps"]
    model = build_model(cfg)
    one = model.init(make_generator(kw["seed"], "cuda"))
    head0 = one["lm_head"]["w"].clone()
    n_params = sum(t.numel() for t in tree_leaves(one))
    hcfg = HierarchyConfig(num_edge_servers=1, clients_per_es=C, kappa0=k,
                           kappa1=1)
    batch = _client_round_batch(cfg, C, k, kw["micro"], kw["seq"],
                                seed=kw["seed"], device="cuda")
    ft = {n: v[:, 0] for n, v in _client_round_batch(
        cfg, C, 1, kw["micro"], kw["seq"], seed=777, device="cuda").items()}
    au = torch.full((C,), 1.0 / C, dtype=torch.float32, device="cuda")
    ab = torch.ones((C,), dtype=torch.float32, device="cuda")
    per_forward = attention_layers(cfg)
    tokens = C * k * kw["micro"] * kw["seq"]
    rows, counts_by_policy, base = {}, {}, None
    for name, tcfg in (("none", TrainConfig(remat=False)),
                       ("full", TrainConfig()),
                       ("dots", TrainConfig(remat_policy="dots"))):
        opt, mask = build_optimizer(model, tcfg, params=one)
        params = stack_replicas(one, C)
        state = stack_replicas(opt.init(one), C)
        round_ = make_host_round(model, hcfg, tcfg, num_clients=C,
                                 global_sync=False)
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(kernels)              # count this path's run alone
        (p, _, metrics), wall = sync_time(
            torch, lambda: round_.fn(params, state, batch, au, ab))
        counts = read_counts(kernels)
        peak = torch.cuda.max_memory_allocated()
        del params, state
        loss = float(metrics["loss"])
        gp = tree_map(lambda x: x[0], p)
        reset_counts(kernels)
        (bank, ft_losses), bank_s = sync_time(
            torch, lambda: personalize_head_bank(model, gp, ft, tcfg))
        pers = personalized_eval(model, gp, bank, ft)
        glob = personalized_eval(model, gp, gp["lm_head"]["w"][None].expand(
            bank.shape), ft)
        bank_counts = read_counts(kernels)
        gain = float((glob - pers).mean())
        # the round's peak is its edge step's (float32 copies of the
        # stacked 262M-row embedding and head); a local step alone on
        # client 0's batch shows what the policy keeps for the backward
        local = local_steps(model, opt, mask, tcfg)
        mb = {n: v[0] for n, v in batch.items()}
        s0 = opt.init(one)
        torch.cuda.synchronize()
        step_held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        _, step_s = sync_time(torch, lambda: local(one, s0, mb))
        step_peak = torch.cuda.max_memory_allocated() - step_held
        # that peak is the SGD update's (gradients, updates and new
        # parameters, 1.96 GB each) once remat frees the activations; what
        # the forward keeps for the backward is read after the loss
        leaves = tree_map(lambda x, m: x.detach().requires_grad_(m), one,
                          mask)
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        kept = model.loss(leaves, {n: v[0] for n, v in mb.items()},
                          remat=tcfg.remat, remat_policy=None
                          if tcfg.remat_policy == "full"
                          else tcfg.remat_policy)
        saved = torch.cuda.memory_allocated() - before
        del kept, leaves
        factor = 2 if tcfg.remat else 1
        expected = C * k * per_forward * factor
        if base is None:
            base, diff, bit_equal = p, 0.0, True
        else:
            pairs = list(zip(tree_leaves(p), tree_leaves(base)))
            diff = max(float((a.float() - b.float()).abs().max())
                       for a, b in pairs)
            bit_equal = all(torch.equal(a, b) for a, b in pairs)
            for (path, a), b in zip(path_leaves(p), tree_leaves(base)):
                assert torch.allclose(a.float(), b.float(), rtol=2e-5,
                                      atol=2e-6), (name, path)
        rows[name] = {
            "remat": tcfg.remat, "remat_policy": tcfg.remat_policy,
            "round_wall_s": wall, "tokens_per_s": tokens / wall,
            "peak_mem_GB": peak / 1e9,
            "peak_above_round_inputs_GB": (peak - held) / 1e9,
            "local_step_wall_s": step_s,
            "local_step_peak_above_held_GB": step_peak / 1e9,
            "forward_saved_for_backward_GB": saved / 1e9,
            "loss": loss, "launches": counts,
            "flash_launches_expected": expected,
            "bank_s": bank_s, "bank_launches": bank_counts,
            "bank_flash_launches_expected": 3 * per_forward,
            "finetune_losses": ft_losses.cpu().tolist(),
            "personalization_gain": gain,
            "params_max_abs_diff_vs_none": diff,
            "params_bit_equal_to_none": bit_equal,
            "head_frozen": _heads_frozen(torch, p, head0),
            "clients_equal": _replicas_equal(torch, p)}
        counts_by_policy[name] = counts
        del p, gp, bank, pers, glob
        assert math.isfinite(loss), (name, loss)
        assert rows[name]["head_frozen"] and rows[name]["clients_equal"], name
        assert counts["flash_attention"] == expected, (name, counts)
        assert bank_counts["flash_attention"] == 3 * per_forward, (
            name, bank_counts)
        assert (counts["quantize"] == counts["mlstm_chunk"]
                == counts["rglru_scan"] == 0), counts
        assert gain > 0, (name, gain)
    emit({"phase": "train_seamless", "config": {
              "arch": cfg.name, "encoder_layers":
                  cfg.encdec.num_encoder_layers,
              "decoder_layers": cfg.num_layers, "d_model": cfg.d_model,
              "heads": cfg.num_heads, "head_dim": cfg.head_dim,
              "source_frames": cfg.encdec.max_source_len,
              "vocab": cfg.padded_vocab, "dtype": cfg.dtype,
              "edge_servers": 1, **kw},
          "params": n_params, "tokens_per_round": tokens,
          "flash_launches_expected_from": "clients x local steps x "
          "(encoder + decoder layers) x (2 under remat: the recompute)",
          "rounds": rows})
    return counts_by_policy


def phase_reference_train_remat(torch, np, kernels):
    """One host round at reference_train's config (xlstm-350m.reduced(),
    float32: K3's float32 route; 2 clients x 2 local steps of 2 x 64
    tokens, lr 0.05) on the card under the reference's default remat
    ("full") against the same round without it: the parameters, optimizer
    states and loss within TRAIN_TOL (bit-equality reported).  Counts set
    to 0 just before each round and read just after: K3 once per mLSTM
    layer a local step's forward, twice under remat (the backward's
    recompute)."""
    from repro_torch.configs.base import MLSTM, HierarchyConfig, TrainConfig
    from repro_torch.configs.registry import get_arch
    from repro_torch.core.phsfl import (build_optimizer, make_host_round,
                                        stack_replicas)
    from repro_torch.launch.train import _client_round_batch
    from repro_torch.models.registry import build_model
    from repro_torch.utils.prng import make_generator
    from repro_torch.utils.tree import tree_leaves
    kw = TRAIN_REFERENCE
    cfg = get_arch("xlstm-350m").reduced()
    C, k = kw["clients"], kw["local_steps"]
    model = build_model(cfg)
    one = model.init(make_generator(kw["seed"], "cuda"))
    hcfg = HierarchyConfig(num_edge_servers=1, clients_per_es=C, kappa0=k,
                           kappa1=1)
    batch = _client_round_batch(cfg, C, k, kw["micro"], kw["seq"],
                                seed=kw["seed"], device="cuda")
    au = torch.full((C,), 1.0 / C, dtype=torch.float32, device="cuda")
    ab = torch.ones((C,), dtype=torch.float32, device="cuda")
    n_mlstm = sum(kind == MLSTM for kind in cfg.layer_kinds())
    out, counts, walls = {}, {}, {}
    for name, remat in (("full", True), ("none", False)):
        tcfg = TrainConfig(learning_rate=kw["lr"], remat=remat)
        opt, _ = build_optimizer(model, tcfg, params=one)
        round_ = make_host_round(model, hcfg, tcfg, num_clients=C,
                                 global_sync=False)
        params = stack_replicas(one, C)
        state = stack_replicas(opt.init(one), C)
        reset_counts(kernels)              # count this path's run alone
        out[name], walls[name] = sync_time(
            torch, lambda: round_.fn(params, state, batch, au, ab))
        counts[name] = read_counts(kernels)
    (pr, sr, mr), (pn, sn, mn) = out["full"], out["none"]
    pairs = (list(zip(tree_leaves(pr), tree_leaves(pn)))
             + list(zip(tree_leaves(sr), tree_leaves(sn))))
    diff = max(float((a - b).abs().max()) for a, b in pairs)
    bit_equal = all(torch.equal(a, b) for a, b in pairs)
    expected = {name: C * k * n_mlstm * f
                for name, f in (("full", 2), ("none", 1))}
    emit({"phase": "reference_train_remat", "config": cfg.name,
          "dtype": cfg.dtype, **kw, "rounds": 1,
          "loss": {"full": float(mr["loss"]), "none": float(mn["loss"])},
          "round_wall_s": walls, "launches": counts,
          "mlstm_launches_expected": expected,
          "params_state_max_abs_diff": diff, "bit_equal": bit_equal,
          "tol": TRAIN_TOL})
    np.testing.assert_allclose(float(mr["loss"]), float(mn["loss"]),
                               **TRAIN_TOL)
    for a, b in pairs:
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(),
                                   **TRAIN_TOL)
    for name in ("full", "none"):
        assert counts[name]["mlstm_chunk"] == expected[name], (name, counts)
        assert (counts[name]["quantize"] == counts[name]["flash_attention"]
                == counts[name]["rglru_scan"] == 0), counts
    return counts["full"]



# ------------------------------------------------------- the mesh slice ----
def _flat_numpy(tree) -> dict:
    from repro_torch.utils.tree import path_leaves
    return {p: t.detach().float().cpu().numpy() for p, t in path_leaves(tree)}


def _max_abs_diff(np, a: dict, b: dict) -> float:
    assert a.keys() == b.keys(), sorted(set(a) ^ set(b))
    return max(float(np.abs(a[k] - b[k]).max()) for k in a)


def _bit_equal(np, a: dict, b: dict) -> bool:
    assert a.keys() == b.keys(), sorted(set(a) ^ set(b))
    return all(np.array_equal(a[k], b[k]) for k in a)


def _shared_step_run(torch, arch, mesh, device):
    """One shared-server step of MESH_SHARED's clients at ``arch``'s
    reduced config on ``device``, from the CPU init of seed 0, then both
    ``sync_clients``: (params, state, loss, pod mean, global mean) on the
    host, and the step's kernel launches."""
    from repro_torch.configs.base import HierarchyConfig, TrainConfig
    from repro_torch.configs.registry import get_arch
    from repro_torch.core.phsfl import (build_optimizer,
                                        init_shared_server_params,
                                        make_shared_server_step)
    from repro_torch.hopper.flash_attention import kernel as fa
    from repro_torch.launch.train import _client_round_batch
    from repro_torch.models.registry import build_model
    from repro_torch.utils.prng import make_generator
    from repro_torch.utils.tree import tree_map
    kw = MESH_SHARED
    cfg = get_arch(arch).reduced()
    model = build_model(cfg)
    C = kw["clients"]
    tcfg = TrainConfig(learning_rate=0.05, freeze_head=True, remat=False)
    params = tree_map(lambda t: t.to(device), init_shared_server_params(
        model, make_generator(0, "cpu"), C))
    opt, _ = build_optimizer(model, tcfg, params=params)
    state = opt.init(params)
    batch = {n: v[:, 0] for n, v in _client_round_batch(
        cfg, C, 1, kw["micro"], kw["seq"], seed=0, device=device).items()}
    step = make_shared_server_step(
        model, HierarchyConfig(num_edge_servers=1, clients_per_es=C), tcfg,
        mesh, C)
    before = fa.launches
    p, s, m = step.fn(params, state, batch)
    launches = fa.launches - before
    return (_flat_numpy(p), _flat_numpy(s), float(m["loss"]),
            _flat_numpy(step.sync_clients(p, False)),
            _flat_numpy(step.sync_clients(p, True))), launches


def phase_mesh_nccl(torch, np, kernels):
    """The mesh rounds at world size 1 over NCCL, in this process:
    ``make_phsfl_round`` on xlstm-350m.reduced() (float32: K3's float32
    route) at C = 1, against ``make_host_round`` at C = 1 on the card,
    bit for bit; ``make_shared_server_step`` (four clients on the one
    rank) on reduced mistral-large-123b and reduced olmoe-1b-7b (the MoE;
    K2 in both), then both ``sync_clients``, against the same step on the
    CPU (a one-rank gloo group) within MESH_TOL.  Counts set to 0 just
    before each run and read just after."""
    import torch.distributed as dist
    from repro_torch.configs.base import (MLSTM, HierarchyConfig,
                                          TrainConfig)
    from repro_torch.configs.registry import get_arch
    from repro_torch.core.phsfl import (build_optimizer, make_host_round,
                                        make_phsfl_round, stack_replicas)
    from repro_torch.launch.distributed import free_port
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import _client_round_batch
    from repro_torch.models.registry import build_model
    from repro_torch.utils.prng import make_generator
    kw = MESH_XLSTM
    cfg = get_arch("xlstm-350m").reduced()
    model = build_model(cfg)
    hcfg = HierarchyConfig(num_edge_servers=1, clients_per_es=1,
                           kappa0=kw["local_steps"], kappa1=1)
    tcfg = TrainConfig(learning_rate=0.05, freeze_head=True, remat=False)
    one = model.init(make_generator(0, "cuda"))
    opt, _ = build_optimizer(model, tcfg, params=one)
    params, state = stack_replicas(one, 1), stack_replicas(opt.init(one), 1)
    batch = _client_round_batch(cfg, 1, kw["local_steps"], kw["micro"],
                                kw["seq"], seed=0, device="cuda")
    au = torch.ones(1, device="cuda")
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{free_port()}", rank=0, world_size=1)
    try:
        backend = dist.get_backend()
        mesh = make_mesh((1, 1), ("data", "model"), device_type="cuda")
        round_ = make_phsfl_round(model, hcfg, tcfg, mesh, global_sync=False)
        reset_counts(kernels)
        (pm, sm, mm), wall = sync_time(
            torch, lambda: round_.fn(params, state, batch, au, au))
        round_counts = read_counts(kernels)
        host = make_host_round(model, hcfg, tcfg, num_clients=1,
                               global_sync=False)
        ph, sh, mh = host.fn(params, state, batch, au, au)
        round_equal = (_bit_equal(np, _flat_numpy(pm), _flat_numpy(ph))
                       and _bit_equal(np, _flat_numpy(sm), _flat_numpy(sh))
                       and float(mm["loss"]) == float(mh["loss"]))
        card, shared_counts = {}, {}
        for arch in MESH_SHARED_ARCHS:
            reset_counts(kernels)
            card[arch], _ = _shared_step_run(torch, arch, mesh, "cuda")
            shared_counts[arch] = read_counts(kernels)
    finally:
        dist.destroy_process_group()
    dist.init_process_group("gloo", init_method=f"tcp://localhost:"
                            f"{free_port()}", rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), device_type="cpu")
        cpu = {a: _shared_step_run(torch, a, mesh, "cpu")[0]
               for a in MESH_SHARED_ARCHS}
    finally:
        dist.destroy_process_group()
    diffs = {}
    for arch in MESH_SHARED_ARCHS:
        (cp, cs, cl, cpod, call), (hp, hs, hl, hpod, hall) = (card[arch],
                                                             cpu[arch])
        diffs[arch] = {"params": _max_abs_diff(np, cp, hp),
                       "state": _max_abs_diff(np, cs, hs),
                       "loss_rel": abs(cl - hl) / abs(hl),
                       "sync_pod": _max_abs_diff(np, cpod, hpod),
                       "sync_all": _max_abs_diff(np, call, hall)}
    n_mlstm = sum(k == MLSTM for k in cfg.layer_kinds())
    expected = {"xlstm_round": kw["local_steps"] * n_mlstm,
                **{a: MESH_SHARED["clients"] * attention_layers(
                    get_arch(a).reduced()) for a in MESH_SHARED_ARCHS}}
    emit({"phase": "mesh_nccl", "backend": backend, "world_size": 1,
          "xlstm_round": {"config": cfg.name, "dtype": cfg.dtype,
                          "clients": 1, **kw, "round_wall_s": wall,
                          "loss": float(mm["loss"]),
                          "bit_equal_to_host_round": round_equal,
                          "launches": round_counts},
          "shared_server": {"configs": [get_arch(a).reduced().name
                                        for a in MESH_SHARED_ARCHS],
                            **MESH_SHARED, "cuda_vs_cpu_max_abs_diff": diffs,
                            "tol": MESH_TOL, "launches": shared_counts},
          "launches_expected": expected})
    assert backend == "nccl", backend
    assert round_equal
    assert round_counts["mlstm_chunk"] == expected["xlstm_round"], round_counts
    for arch in MESH_SHARED_ARCHS:
        assert all(v <= MESH_TOL for v in diffs[arch].values()), diffs
        assert shared_counts[arch]["flash_attention"] == expected[arch], (
            arch, shared_counts)
    return {"xlstm_round": round_counts, **shared_counts}


def _reference_mesh_rank(rank, world, dev, inputs, tp_refs=None,
                         family_refs=None):
    """One client rank of reference_mesh on the shared card: the three
    mesh rounds from the same inputs (its K2 launches counted), and on
    rank 0 the port's host round of all four clients on the card; then,
    with ``tp_refs``, tp_gemma's (data 2, model 2) mesh over the same
    ranks, and with ``family_refs`` tp_families' on it (``_tp_rank``)."""
    import torch
    from repro_torch.core.phsfl import client_index, make_phsfl_round
    from repro_torch.hopper.flash_attention import kernel as fa
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.registry import build_model
    from repro_torch.utils.tree import tree_map
    cfg, hcfg, tcfg = _reference_mesh_configs()
    model = build_model(cfg)
    params, state, batch, au, ab = (
        tree_map(lambda a: torch.from_numpy(a).to(dev), x) for x in inputs)
    mesh = make_mesh((2, 2, 1), ("pod", "data", "model"), device_type="cuda")
    c = client_index(mesh)
    mine = lambda t: t[c:c + 1]
    args = (tree_map(mine, params), tree_map(mine, state),
            tree_map(mine, batch), mine(au), mine(ab))
    rounds = {"plain": make_phsfl_round(model, hcfg, tcfg, mesh,
                                        global_sync=True)}
    masked = make_phsfl_round(model, hcfg, tcfg, mesh, global_sync=True,
                              participation=True)
    out = {"client": c, "backend": torch.distributed.get_backend(),
           "device": str(dev)}
    fa.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p, s, m = rounds["plain"].fn(*args)
    out["plain"] = (_flat_numpy(p), _flat_numpy(s), float(m["loss"]))
    for name, mask in MESH_MASKS.items():
        p, s, m = masked.fn(*args, mine(torch.tensor(mask, device=dev)))
        out[name] = (_flat_numpy(p), _flat_numpy(s), float(m["loss"]))
    torch.cuda.synchronize()
    out["wall_s"] = time.perf_counter() - t0
    out["flash_launches"] = fa.launches
    if rank == 0:
        out["host"] = _reference_mesh_host(torch, model, hcfg, tcfg, params,
                                           state, batch, au, ab, dev)
    if tp_refs is not None:
        del params, state, batch, args
        torch.cuda.empty_cache()
        out["tp"] = _tp_rank(rank, dev, tp_refs)
    if family_refs is not None:
        torch.cuda.empty_cache()
        out["tp_families"] = _tp_rank(rank, dev, family_refs)
    return out


def _reference_mesh_configs():
    from repro_torch.configs.base import HierarchyConfig, TrainConfig
    from repro_torch.configs.registry import get_arch
    kw = MESH_REFERENCE
    return (get_arch(kw["arch"]).reduced(),
            HierarchyConfig(num_edge_servers=2, clients_per_es=2,
                            kappa0=kw["local_steps"], kappa1=1),
            TrainConfig(learning_rate=0.05, freeze_head=True, remat=False))


def _reference_mesh_host(torch, model, hcfg, tcfg, params, state, batch,
                         au, ab, dev):
    """The port's host round of reference_mesh's three cases on ``dev``:
    {case: (params, state, loss)} as (C, ...) numpy."""
    from repro_torch.core.phsfl import make_host_round
    C = MESH_REFERENCE["clients"]
    plain = make_host_round(model, hcfg, tcfg, num_clients=C,
                            global_sync=True)
    masked = make_host_round(model, hcfg, tcfg, num_clients=C,
                             global_sync=True, participation=True)
    out = {}
    p, s, m = plain.fn(params, state, batch, au, ab)
    out["plain"] = (_flat_numpy(p), _flat_numpy(s), float(m["loss"]))
    for name, mask in MESH_MASKS.items():
        p, s, m = masked.fn(params, state, batch, au, ab,
                            torch.tensor(mask, device=dev))
        out[name] = (_flat_numpy(p), _flat_numpy(s), float(m["loss"]))
    return out


def phase_reference_mesh(torch, np, kernels, tp_refs=None,
                         family_refs=None):
    """``make_phsfl_round`` on four ranks spawned on the one card over gloo
    (pod 2 x data 2 x model 1: two ESs of two clients), reduced
    mistral-large-123b (float32; K2 in its attention), 2 local steps of
    2 x 32 tokens, uneven alpha_u and alpha_b: unmasked with global sync,
    then masked with two clients lost (one an ES) and with ES 0 emptied.
    Each rank's client against the port's host round of the four clients
    on the card (bit for bit, as predicted) and on the CPU (within
    MESH_TOL).  Each rank counts its own K2 launches.  With ``tp_refs``
    the same ranks then run tp_gemma, and with ``family_refs``
    tp_families (each ``_tp_rank``).  Returns the counts and
    the ranks' results."""
    from repro_torch.core.phsfl import build_optimizer, stack_replicas
    from repro_torch.launch.distributed import spawn
    from repro_torch.launch.train import _client_round_batch
    from repro_torch.models.registry import build_model
    from repro_torch.utils.prng import make_generator
    from repro_torch.utils.tree import tree_map
    kw = MESH_REFERENCE
    C = kw["clients"]
    cfg, hcfg, tcfg = _reference_mesh_configs()
    model = build_model(cfg)
    one = model.init(make_generator(0, "cpu"))
    opt, _ = build_optimizer(model, tcfg, params=one)
    params, state = stack_replicas(one, C), stack_replicas(opt.init(one), C)
    batch = _client_round_batch(cfg, C, kw["local_steps"], kw["micro"],
                                kw["seq"], seed=0)
    au, ab = torch.tensor(MESH_ALPHA_U), torch.tensor(MESH_ALPHA_B)
    cpu = _reference_mesh_host(torch, model, hcfg, tcfg, params, state,
                               batch, au, ab, "cpu")
    inputs = tuple(tree_map(lambda t: t.numpy(), x)
                   for x in (params, state, batch, au, ab))
    torch.cuda.empty_cache()
    ranks, wall = sync_time(torch, lambda: spawn(
        _reference_mesh_rank, C, (inputs, tp_refs, family_refs),
        device="cuda", threads=2, timeout=900))
    card = ranks[0]["host"]
    rows = {}
    for case in ("plain", *MESH_MASKS):
        worst_cpu, equal = 0.0, True
        for r in ranks:
            c = r["client"]
            for got, want_card, want_cpu in zip(r[case][:2], card[case][:2],
                                                cpu[case][:2]):
                for k in want_card:
                    equal &= bool(np.array_equal(got[k][0], want_card[k][c]))
                    worst_cpu = max(worst_cpu, float(np.abs(
                        got[k][0] - want_cpu[k][c]).max()))
        rows[case] = {"bit_equal_to_card_host_round": equal,
                      "max_abs_diff_vs_cpu": worst_cpu,
                      "loss": ranks[0][case][2],
                      "loss_card_host": card[case][2],
                      "loss_cpu_host": cpu[case][2]}
    per_rank = [r["flash_launches"] for r in ranks]
    expected = (1 + len(MESH_MASKS)) * kw["local_steps"] * attention_layers(
        cfg)
    emit({"phase": "reference_mesh", "config": cfg.name, "dtype": cfg.dtype,
          "mesh": {"pod": 2, "data": 2, "model": 1},
          "backend": [r["backend"] for r in ranks],
          "devices": [r["device"] for r in ranks], **kw,
          "alpha_u": MESH_ALPHA_U, "alpha_b": MESH_ALPHA_B,
          "masks": MESH_MASKS, "cases": rows, "tol": MESH_TOL,
          "spawn_wall_s": wall, "rank_round_wall_s": [r["wall_s"]
                                                      for r in ranks],
          "flash_launches_per_rank": per_rank,
          "flash_launches_expected_per_rank": expected})
    assert [r["client"] for r in ranks] == list(range(C))
    assert all(b == "gloo" for b in (r["backend"] for r in ranks))
    for case, row in rows.items():
        assert row["max_abs_diff_vs_cpu"] <= MESH_TOL, (case, row)
        assert abs(row["loss"] - row["loss_cpu_host"]) <= MESH_TOL * abs(
            row["loss_cpu_host"]), (case, row)
    assert all(n == expected for n in per_rank), (per_rank, expected)
    return {"flash_attention": per_rank}, ranks


def _digests(tree, clients) -> dict:
    """sha256 of each leaf's bytes, for each of ``clients`` rows of the
    stacked (n, ...) tree."""
    import hashlib

    import torch
    from repro_torch.utils.tree import path_leaves
    out = {}
    for path, x in path_leaves(tree):
        for i, c in enumerate(clients):
            raw = x[i].contiguous().view(-1).view(torch.uint8).cpu().numpy()
            out[(path, c)] = hashlib.sha256(raw.tobytes()).hexdigest()
    return out


def _seamless_rank(rank, world, dev, kw):
    """One client rank of train_mesh_seamless: ``train()`` under the gloo
    group, its K2 launches, and the seconds and bytes of its
    ``all_reduce`` calls (the edge step's, and the loss's mean)."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs.registry import get_arch
    from repro_torch.hopper.flash_attention import kernel as fa
    from repro_torch.launch.train import train
    from repro_torch.telemetry import MetricLogger
    reduce = dist.all_reduce
    traffic = {"calls": 0, "bytes": 0, "seconds": 0.0}

    def timed(t, *a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = reduce(t, *a, **k)
        torch.cuda.synchronize()
        traffic["seconds"] += time.perf_counter() - t0
        traffic["calls"] += 1
        traffic["bytes"] += t.numel() * t.element_size()
        return out

    dist.all_reduce = timed
    fa.launches = 0
    try:
        res = train(get_arch("seamless-m4t-medium"), device=dev,
                    log=MetricLogger(f"train_mesh_seamless.{rank}",
                                     sys.stderr), **kw)
    finally:
        dist.all_reduce = reduce
    return {"client": rank, "backend": dist.get_backend(),
            "device": str(dev), "round_wall_s": res.round_seconds,
            "losses": res.losses, "peak_mem_GB": res.peak_mem_GB,
            "flash_launches": fa.launches, "all_reduce": traffic,
            "gain": res.personalization_gain,
            "digests": _digests(res.params, [rank])}


def phase_train_mesh_seamless(torch, np, kernels):
    """seamless-m4t-medium whole (bf16, 0.98 B) trained through
    ``launch/train.py``'s ``train()`` on two ranks spawned on the one card
    over gloo, one client each: one round of one local step of 1 x 2048
    tokens over 1024 frames (lr 0.01, 10 head steps: the reference's
    TrainConfig).  First the same ``train()`` without a group (the host
    round of the two clients, as train_seamless runs it) in this process,
    whose cached memory is then freed.  Each rank's parameters against the
    host round's client, bit for bit (sha256 of every leaf), the head
    against the init's; each rank's round wall time, peak, K2 launches
    and the seconds and bytes of its edge ``all_reduce``."""
    import gc
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch.distributed import spawn
    from repro_torch.launch.train import train
    from repro_torch.models.registry import build_model
    from repro_torch.telemetry import MetricLogger
    from repro_torch.utils.prng import make_generator
    kw = TRAIN_MESH_SEAMLESS
    cfg = get_arch("seamless-m4t-medium")
    C = kw["clients"]
    head0 = build_model(cfg).init(make_generator(kw["seed"], "cuda"))[
        "lm_head"]["w"]
    head_digest = _digests({"lm_head": {"w": head0[None]}}, [0])[
        ("lm_head/w", 0)]
    del head0
    host, host_wall = sync_time(torch, lambda: train(
        cfg, device="cuda", log=MetricLogger("train_mesh_seamless.host",
                                             sys.stderr), **kw))
    want = _digests(host.params, range(C))
    host_row = {"round_wall_s": host.round_seconds, "losses": host.losses,
                "peak_mem_GB": host.peak_mem_GB,
                "gain": host.personalization_gain}
    del host
    gc.collect()
    torch.cuda.empty_cache()
    ranks, wall = sync_time(torch, lambda: spawn(
        _seamless_rank, C, (kw,), device="cuda", timeout=900))
    equal = all(r["digests"][(p, r["client"])] == want[(p, r["client"])]
                for r in ranks for (p, c) in want if c == r["client"])
    replicas = all(r["digests"][(p, r["client"])] == want[(p, 0)]
                   for r in ranks for (p, c) in want if c == 0)
    frozen = all(r["digests"][("lm_head/w", r["client"])] == head_digest
                 for r in ranks)
    per_forward = attention_layers(cfg)
    expected = (kw["rounds"] * kw["local_steps"] + 3) * per_forward
    emit({"phase": "train_mesh_seamless", "config": {
              "arch": cfg.name, "dtype": cfg.dtype, **kw},
          "backend": [r["backend"] for r in ranks],
          "devices": [r["device"] for r in ranks],
          "bit_equal_to_host_round": equal, "replicas_equal": replicas,
          "head_frozen": frozen, "spawn_wall_s": wall,
          "host": host_row, "host_train_wall_s": host_wall,
          "ranks": [{k: r[k] for k in ("client", "round_wall_s", "losses",
                                        "peak_mem_GB", "flash_launches",
                                        "all_reduce", "gain")}
                    for r in ranks],
          "flash_launches_expected_per_rank": expected,
          "flash_launches_expected_from": "(rounds x local steps + the "
          "bank's trunk pass + two evaluations) x (encoder + decoder "
          "layers)"})
    assert equal and replicas and frozen, (equal, replicas, frozen)
    for r in ranks:
        assert r["flash_launches"] == expected, (r["flash_launches"],
                                                 expected)
        assert r["losses"] == host_row["losses"], (r["losses"], host_row)
        assert r["gain"] == host_row["gain"], (r["gain"], host_row)
    return {"flash_attention": [r["flash_launches"] for r in ranks]}


# ------------------------------------------------ the launch tools (PR 23) --
# steps_gemma: gemma3-12b at the serving cell's cut (12 layers, 4.70 B),
# full width, bf16, through steps.build_step on a (data 1, model 1) mesh of
# one NCCL rank; each shape's name, length and kind as published, the
# batch cut as listed (prefill 32 -> 1, decode 128 -> 2, train 256 -> 2:
# 1 client x 2 local steps x micro 1)
STEPS_GEMMA_LAYERS = 12
STEPS_GEMMA = {"prefill": ("prefill_32k", 32768, 1, "prefill"),
               "decode": ("decode_32k", 32768, 2, "decode"),
               "train": ("train_4k", 4096, 2, "train")}
STEPS_DECODE_STEPS = 8
# tp_gemma: tensor parallelism on the one card, inside reference_mesh's
# four gloo ranks, over a second mesh (data 2, model 2): gemma3-12b at 2
# layers, full width, bf16, and its reduced() config in float32; the
# prefill step (2 x 2048 tokens, fsdp_tp: the embed dims gathered over
# "data") and the train round (2 clients x 2 local steps x 1 x 1024
# tokens, remat "full") against the same computations at model 1 on the
# card; the reference's tolerances (tests/test_kernels.py:34): the
# logits' relative to their largest magnitude above 1, the round's on each
# leaf's update (after - before) relative to the update's largest
# magnitude, plus the rounding of the stored weights: one ulp of the
# leaf's largest value for each write of them (the 2 local steps and the
# edge average).  At the paper's 0.01 a bf16 weight of this width moves
# by far less than its ulp and most do not move at all, so the bf16
# case's learning rate is 1000, which lifts the weights' updates to
# several ulps (the phase prints each case's largest update, margins and
# the leaves that did not move: in bf16 the norm scales, whose float32
# case checks them).  The update must stand TP_MARGIN times above its
# limit on the median leaf: a leaf's gradient half lost (a missing sum
# over "model") then errs by 1.5 limits
TP_GEMMA_LAYERS = 2
TP_PREFILL = ("prefill_tp", 2048, 2, "prefill")
TP_TRAIN = ("train_tp", 1024, 4, "train")
TP_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
TP_LR = {"float32": 0.01, "bfloat16": 1000.0}
TP_MARGIN = 3
TP_ALPHA_U = (0.5, 0.5)
# the cross-attention's k bias (its keys take no rotation) adds q.b to
# every logit of a query, which the softmax cancels: its exact gradient is
# 0, so its update is rounding noise on both sides, held under the
# tolerance of the round's largest update instead
TP_ZERO_GRAD = ("cross/k/b",)
# tp_families: tensor parallelism for the other families, on the
# same four gloo ranks and (data 2, model 2) mesh as tp_gemma, after it.
# Each family at its published widths, cut in depth so that each block
# kind appears at least once, bf16: olmoe-1b-7b and deepseek-v2-236b at 2
# layers (deepseek: the dense first layer, then MLA + MoE of 160 experts
# top-6 plus 2 shared), recurrentgemma-2b at 3 (RG-LRU, RG-LRU, local
# attention), xlstm-350m at 2 (mLSTM, sLSTM), seamless-m4t-medium at 2 +
# 2; and each family's reduced() config in float32 (recurrentgemma at 3
# layers, the MoEs widened as zoo_config widens them).  The prefill step
# and the train round as tp_gemma holds them.  deepseek's cut is 5.1 B
# parameters, 10.2 GB in bf16 (its MoE layer alone 160 x 3 x 5120 x 1536
# x 2 B = 7.55 GB, 3.77 GB a model rank): its round at model 1 would
# hold three stacked copies of two clients' replicas (~61 GB) beside the
# four ranks' blocks, so its bf16 case runs the prefill only.  xlstm's
# round is cut to 256 tokens a client step: its sLSTM is a loop over
# time.
TP_FAMILY_LAYERS = {"olmoe-1b-7b": 2, "deepseek-v2-236b": 2,
                    "recurrentgemma-2b": 3, "xlstm-350m": 2,
                    "seamless-m4t-medium": 2}
TP_FAMILY_TRAIN = {"xlstm-350m": ("train_tp_xlstm", 256, 4, "train")}
# the bf16 rounds take one local step: at lr 1000 (which lifts a bf16
# update above its ulps) a second step starts from weights moved far from
# the init, where the MoE's routing, seamless's attention logits and the
# xLSTM's gates amplify the two orders of summation's roundings (and
# xlstm's overflows): it would check chaos, not the gradient
TP_FAMILY_STEPS = {"bfloat16": 1, "float32": 2}
# the bf16 cuts whose round holds at tp_gemma's limit on the H100
# (PERF.md §6): olmoe's does not (in its bf16 prefill 6-48 of 2048 tokens
# a layer and rank take another expert under the TP sums) and
# xlstm's reads 1.5-1.75 of the limit (its row-split q/k/v rounded to bf16
# twice, then the exponential gates): those two hold their round at the
# published widths in float32 instead ("cut_float32"), olmoe's routing
# replaying model 1's choices (below); deepseek's bf16 cut runs the
# prefill only (above)
TP_FAMILY_BF16_ROUNDS = {"recurrentgemma-2b", "seamless-m4t-medium"}
TP_FAMILY_F32_CUTS = {"olmoe-1b-7b", "xlstm-350m"}
# A MoE round replays model 1's expert choices, call by call, on each rank
# (the reference's routing injected, as the CPU parity tests inject its
# draws): a near-tie token flips under any reordering of the router's
# input sums, and one flip moves an expert's update by a token's share.
# dryrun: the port's dry run on the card's machine, gemma3-12b whole on the
# (16, 16) production mesh over a fake group of 256 ranks, fake CUDA tensors
DRYRUN_ARCH = "gemma3-12b"
# ... and deepseek-v2-236b whole (MoE + MLA, the zoo's largest) at
# train_4k with one local step a round (two took 161 s to trace on a CPU)
DRYRUN_MOE = ("deepseek-v2-236b", "train_4k")
DRYRUN_MOE_LOCAL_STEPS = 1


def _gemma_cut(layers):
    import dataclasses
    from repro_torch.configs.registry import get_arch
    return dataclasses.replace(get_arch("gemma3-12b"), num_layers=layers)


def _tensors_equal(torch, a, b) -> bool:
    from repro_torch.utils.tree import tree_leaves
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


def phase_steps_gemma(torch, np, kernels):
    """The step builders on the card: gemma3-12b at 12 layers, full width,
    bf16, on a (data 1, model 1) mesh of one NCCL rank in this process.
    prefill at prefill_32k's 32768 tokens (batch cut to 1) against
    ``transformer.prefill``; decode over decode_32k's 32768-token cache
    (batch cut to 2; random bf16 contents) for 8 steps at its last
    positions against the ``decode_step`` loop; the train round at
    train_4k's 4096 tokens (1 client x 2 local steps x micro 1, the
    default TrainConfig: remat "full") against ``make_host_round`` at
    C = 1.  Each bit for bit, on the same parameters and inputs.  Counts
    set to 0 just before each bundle's run and read just after."""
    import gc
    import torch.distributed as dist
    from repro_torch.configs.base import (HierarchyConfig, ShapeConfig,
                                          TrainConfig)
    from repro_torch.core.phsfl import (build_optimizer, make_host_round,
                                        stack_replicas)
    from repro_torch.launch import analytic, roofline
    from repro_torch.launch.distributed import free_port
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import build_step
    from repro_torch.launch.train import _client_round_batch
    from repro_torch.models import transformer as tf
    from repro_torch.models.registry import build_model
    from repro_torch.utils.prng import make_generator
    from repro_torch.utils.tree import tree_leaves, tree_map
    cfg = _gemma_cut(STEPS_GEMMA_LAYERS)
    model = build_model(cfg)
    params = model.init(make_generator(0, "cuda"))
    n_params = sum(t.numel() for t in tree_leaves(params))
    param_bytes = sum(t.numel() * t.element_size()
                      for t in tree_leaves(params))
    n_attn = attention_layers(cfg)
    rows = {}
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{free_port()}", rank=0, world_size=1)
    try:
        backend = dist.get_backend()
        mesh = make_mesh((1, 1), ("data", "model"), device_type="cuda")

        # ---- prefill ----
        shape = ShapeConfig(*STEPS_GEMMA["prefill"])
        b = build_step(cfg, shape, mesh)
        g = torch.Generator().manual_seed(1)
        tok = torch.randint(0, cfg.vocab_size, (shape.global_batch,
                                                shape.seq_len),
                            generator=g).to("cuda")
        batch = {"tokens": tok, "labels": tok}
        b.fn(params, batch)                              # warm-up
        reset_counts(kernels)
        got, wall = sync_time(torch, lambda: b.fn(params, batch))
        counts = read_counts(kernels)
        want = tf.prefill(params, cfg, batch)[0]
        fwd = analytic.forward_flops_per_token(cfg, shape.seq_len,
                                               causal_half=True)
        tokens = shape.global_batch * shape.seq_len
        rows["prefill"] = {
            "shape": STEPS_GEMMA["prefill"], "bit_equal": bool(
                torch.equal(got, want)),
            "seconds": wall, "tokens_per_s": tokens / wall,
            "bound_s": fwd * tokens / roofline.PEAK_FLOPS,
            "bound_from": "analytic forward FLOPs (flash) / 989 TFLOP/s",
            "finite": bool(torch.isfinite(got).all()),
            "launches": counts, "launches_expected": n_attn}
        del got, want, batch, tok
        gc.collect()
        torch.cuda.empty_cache()

        # ---- decode ----
        shape = ShapeConfig(*STEPS_GEMMA["decode"])
        b = build_step(cfg, shape, mesh)
        cache = model.init_cache(shape.global_batch, shape.seq_len,
                                 dtype=torch.bfloat16, device="cuda")
        gen = torch.Generator(device="cuda").manual_seed(2)
        for leaf in tree_leaves(cache):
            leaf.copy_(torch.randn(leaf.shape, generator=gen, device="cuda")
                       * 0.5)
        cache_b = tree_map(torch.clone, cache)
        cache_bytes = sum(t.numel() * t.element_size()
                          for t in tree_leaves(cache))
        toks = torch.randint(0, cfg.vocab_size, (STEPS_DECODE_STEPS,
                                                 shape.global_batch, 1),
                             generator=g).to("cuda")
        start = shape.seq_len - STEPS_DECODE_STEPS
        reset_counts(kernels)
        step_s, got = [], []
        for i in range(STEPS_DECODE_STEPS):
            (lg, cache), t = sync_time(torch, lambda: b.fn(
                params, toks[i], cache, start + i))
            step_s.append(t)
            got.append(lg)
        counts = read_counts(kernels)
        equal = True
        for i in range(STEPS_DECODE_STEPS):
            lg, cache_b = model.decode_step(params, toks[i], cache_b,
                                            start + i)
            equal &= bool(torch.equal(lg, got[i]))
        equal &= _tensors_equal(torch, cache, cache_b)
        rows["decode"] = {
            "shape": STEPS_GEMMA["decode"],
            "steps": STEPS_DECODE_STEPS, "first_index": start,
            "bit_equal": equal, "ms_per_step": [t * 1e3 for t in step_s],
            "ms_per_step_median": float(np.median(step_s)) * 1e3,
            "bound_ms": (param_bytes + cache_bytes) / HBM_BYTES_PER_S * 1e3,
            "bound_from": "weights and cache read once at 3.35 TB/s",
            "finite": all(bool(torch.isfinite(x).all()) for x in got),
            "launches": counts, "launches_expected": 0}
        del cache, cache_b, got, toks
        gc.collect()
        torch.cuda.empty_cache()

        # ---- train ----
        shape = ShapeConfig(*STEPS_GEMMA["train"])
        tcfg = TrainConfig()
        b = build_step(cfg, shape, mesh, tcfg=tcfg)
        opt, _ = build_optimizer(model, tcfg, params=params)
        state = stack_replicas(opt.init(params), 1)
        params = stack_replicas(params, 1)
        k = tcfg.local_steps_in_step
        micro = shape.global_batch // k
        batch = _client_round_batch(cfg, 1, k, micro, shape.seq_len, seed=0,
                                    device="cuda")
        au = torch.ones(1, device="cuda")
        torch.cuda.reset_peak_memory_stats()
        reset_counts(kernels)
        (pm, sm, mm), wall = sync_time(torch, lambda: b.fn(
            params, state, batch, au, au))
        counts = read_counts(kernels)
        peak = torch.cuda.max_memory_allocated()
        mesh_loss = float(mm["loss"])
        pm = tree_map(lambda t: t.cpu(), pm)
        sm = tree_map(lambda t: t.cpu(), sm)
        host = make_host_round(model, HierarchyConfig(
            num_edge_servers=1, clients_per_es=1, kappa0=k, kappa1=1), tcfg,
            num_clients=1, global_sync=False)
        ph, sh, mh = host.fn(params, state, batch, au, au)
        equal = (_tensors_equal(torch, pm, tree_map(lambda t: t.cpu(), ph))
                 and _tensors_equal(torch, sm,
                                    tree_map(lambda t: t.cpu(), sh))
                 and mesh_loss == float(mh["loss"]))
        cost = analytic.train_cost(cfg, shape, {"data": 1, "model": 1},
                                   tcfg=tcfg, attn_impl="flash")
        rows["train"] = {
            "shape": STEPS_GEMMA["train"], "clients": 1, "local_steps": k,
            "micro": micro, "bit_equal_to_host_round": equal,
            "round_s": wall, "loss": mesh_loss,
            "tokens_per_s": k * micro * shape.seq_len / wall,
            "bound_s": cost.flops / roofline.PEAK_FLOPS,
            "bound_from": "analytic train FLOPs (flash, remat full: 4x the "
                          "forward) / 989 TFLOP/s",
            "peak_GB": peak / 1e9,
            "peak_reckoned_GB": 3 * param_bytes / 1e9,
            "peak_reckoned_from": "params, their gradients and the new "
                                  "params (bf16), before activations and "
                                  "the edge step's float32 copy of a leaf",
            "finite": math.isfinite(mesh_loss),
            "launches": counts,
            "launches_expected": k * n_attn * 2}
        del params, state, pm, sm, ph, sh
    finally:
        dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "steps_gemma", "backend": backend, "world_size": 1,
          "mesh": {"data": 1, "model": 1},
          "config": {"arch": cfg.name, "num_layers": cfg.num_layers,
                     "params": n_params, "dtype": cfg.dtype}, **rows})
    assert backend == "nccl"
    for kind, row in rows.items():
        assert row.get("bit_equal", row.get("bit_equal_to_host_round")), (
            kind, row)
        assert row["finite"], (kind, row)
        assert row["launches"]["flash_attention"] == row[
            "launches_expected"], (kind, row)
    return {kind: row["launches"] for kind, row in rows.items()}


def _tp_cases():
    from repro_torch.configs.registry import get_arch
    return {case: (cfg, TP_PREFILL, TP_TRAIN, 2) for case, cfg in (
        ("reduced_float32", get_arch("gemma3-12b").reduced()),
        ("gemma3_2layers_bf16", _gemma_cut(TP_GEMMA_LAYERS)))}


def _tp_inputs(torch, cfg, device, prefill=TP_PREFILL, train=TP_TRAIN,
               steps=2):
    """A tensor-parallel case's parameters (seed 0 on the card: the same
    in every process), prefill batch and, with ``train``, the round's
    inputs of ``steps`` local steps (else None for each).  The encoder-decoder's frames are 0.02 x
    N(0, 1) (seed 4 for the prefill, 5 for the round)."""
    from repro_torch.configs.base import ShapeConfig, TrainConfig
    from repro_torch.core.phsfl import build_optimizer
    from repro_torch.launch.train import _client_round_batch
    from repro_torch.models.registry import build_model
    from repro_torch.utils.prng import make_generator
    model = build_model(cfg)
    params = model.init(make_generator(0, device))
    pre = ShapeConfig(*prefill)
    g = torch.Generator().manual_seed(3)
    tok = torch.randint(0, cfg.vocab_size, (pre.global_batch, pre.seq_len),
                        generator=g).to(device)
    pbatch = {"tokens": tok, "labels": tok}
    if cfg.encdec is not None:
        g = torch.Generator().manual_seed(4)
        pbatch["source_embeds"] = 0.02 * torch.randn(
            (pre.global_batch, cfg.encdec.max_source_len, cfg.d_model),
            generator=g).to(device)
    tcfg = TrainConfig(learning_rate=TP_LR[cfg.dtype],
                       local_steps_in_step=steps)
    if train is None:
        return model, params, pbatch, None, None, tcfg
    tr = ShapeConfig(*train)
    k = tcfg.local_steps_in_step
    C = len(TP_ALPHA_U)
    batch = _client_round_batch(cfg, C, k, tr.global_batch // (C * k),
                                tr.seq_len, seed=0, device=device)
    if cfg.encdec is not None:
        # the launcher's frames are a constant 0.02: every source position
        # alike, so the cross-attention's queries (and the norm before
        # them) take an exactly zero gradient; random frames (seed 5)
        g = torch.Generator().manual_seed(5)
        batch["source_embeds"] = 0.02 * torch.randn(
            batch["source_embeds"].shape, generator=g).to(device)
    opt, _ = build_optimizer(model, tcfg, params=params)
    return model, params, pbatch, batch, opt, tcfg


def phase_tp_gemma_prepare(torch, np):
    """tp_gemma's references at model 1 on the card (``_tp_prepare``)."""
    return _tp_prepare(torch, np, "tp_gemma", _tp_cases())


def _tp_prepare(torch, np, name, cases):
    """A tensor-parallel phase's references at model 1 on the card,
    before the spawn: each case's last-position prefill logits and, where
    it has a round, the host round of its two clients; the round's
    expected updates (after - before, float32) are cut for each of the
    four ranks of the (data 2, model 2) mesh (rank = 2 data + model) and
    written, with the ulp of each block's largest value after the round,
    to a git-ignored directory the ranks read (the embedding's rows that
    the batch touches, every other leaf whole).  ``cases``: {case:
    (config, prefill shape, train shape or None, local steps)}."""
    import gc
    from repro_torch.configs.base import HierarchyConfig
    from repro_torch.core.phsfl import make_host_round, stack_replicas
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.sharding.rules import params_specs, shard_params
    from repro_torch.utils.tree import path_leaves, tree_map
    out_dir = ROOT / "build" / name
    out_dir.mkdir(parents=True, exist_ok=True)
    refs = {"name": name, "dir": str(out_dir), "cases": dict(cases),
            "prefill": {}, "host_round_s": {}, "host_peak_GB": {},
            "loss": {}, "prepare_s": {}, "routes": {}}
    mesh = make_mesh((2, 2), ("data", "model"), abstract=True)
    for case, (cfg, prefill, train, steps) in cases.items():
        t0 = time.perf_counter()
        model, params, pbatch, batch, opt, tcfg = _tp_inputs(
            torch, cfg, "cuda", prefill, train, steps)
        routes = {"prefill": [], "round": []}
        with _routes(torch, record=routes["prefill"]):
            lg = model.logits(params, model.apply(params, pbatch)[0][:, -1:])
        refs["prefill"][case] = lg.float().cpu().numpy()
        del lg, pbatch
        if train is not None:
            C = len(TP_ALPHA_U)
            host = make_host_round(model, HierarchyConfig(
                num_edge_servers=1, clients_per_es=C,
                kappa0=tcfg.local_steps_in_step, kappa1=1), tcfg,
                num_clients=C, global_sync=False)
            au = torch.tensor(TP_ALPHA_U, device="cuda")
            torch.cuda.reset_peak_memory_stats()
            with _routes(torch, record=routes["round"]):
                (ph, sh, mh), wall = sync_time(torch, lambda: host.fn(
                    stack_replicas(params, C),
                    stack_replicas(opt.init(params), C), batch, au, au))
            n = len(routes["round"]) // C      # each client's calls, in turn
            routes["round"] = [routes["round"][c * n:(c + 1) * n]
                               for c in range(C)]
            refs["host_round_s"][case] = wall
            refs["host_peak_GB"][case] = (torch.cuda.max_memory_allocated()
                                          / 1e9)
            refs["loss"][case] = float(mh["loss"])
            spec = params_specs(params, model.axes(), mesh, mode="tp")
            touched = torch.unique(batch["tokens"]).cpu()
            for rank in range(4):
                coord = {"data": rank // 2, "model": rank % 2}
                c = coord["data"]
                mine = shard_params(tree_map(lambda x: x[c], ph), spec,
                                    mesh, coord)
                before = dict(path_leaves(shard_params(params, spec, mesh,
                                                       coord)))
                flat = {}
                for p, t in path_leaves(mine):
                    flat[f"{p}@ulp"] = _ulp(torch, t)
                    b0 = before[p]
                    if p == "embed/table":
                        vl = t.shape[0]
                        lo = coord["model"] * vl
                        idx = touched[(touched >= lo) & (touched < lo + vl)]
                        flat["embed_rows_idx"] = (idx - lo).numpy()
                        rows = (idx - lo).to(t.device)
                        t, b0 = t[rows], b0[rows]
                    flat[p] = (t.float() - b0.float()).cpu().numpy()
                np.savez(out_dir / f"{case}_rank{rank}.npz", **flat)
                del mine, before, flat
            del ph, sh, mh, host, batch, opt
        del params
        gc.collect()
        torch.cuda.empty_cache()
        if cfg.moe is not None:
            refs["routes"][case] = routes
        refs["prepare_s"][case] = time.perf_counter() - t0
    return refs


def _ulp(torch, t) -> float:
    """One unit in the last place of ``t``'s largest magnitude, in its
    dtype."""
    import math
    x = float(t.float().abs().max())
    return torch.finfo(t.dtype).eps * 2.0 ** math.floor(math.log2(x)) \
        if x > 0 else 0.0


def _timed_collectives(torch, dist, group):
    """Wrap ``dist.all_reduce``, ``dist.all_gather`` and
    ``dist.reduce_scatter``: the seconds (synchronised), calls and bytes
    (the whole tensor: the reduced one, the gathered one, the one
    scattered) of their calls on ``group``, by kind; returns (traffic,
    restore)."""
    kinds = {"all_reduce": lambda a: a[0].numel() * a[0].element_size(),
             "all_gather": lambda a: sum(t.numel() * t.element_size()
                                         for t in a[0]),
             "reduce_scatter": lambda a: sum(t.numel() * t.element_size()
                                             for t in a[1])}
    traffic = {k: {"calls": 0, "bytes": 0, "seconds": 0.0} for k in kinds}
    saved = {k: getattr(dist, k) for k in kinds}

    def wrap(kind):
        fn = saved[kind]

        def timed(*a, **k):
            if k.get("group") is not group:
                return fn(*a, **k)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            row = traffic[kind]
            row["seconds"] += time.perf_counter() - t0
            row["calls"] += 1
            row["bytes"] += kinds[kind](a)
            return out
        return timed

    for kind in kinds:
        setattr(dist, kind, wrap(kind))

    def restore():
        for kind, fn in saved.items():
            setattr(dist, kind, fn)

    return traffic, restore


def _kernel_launches():
    """K2's, K3's and K4's launch counters, to reset and read."""
    from repro_torch.hopper.flash_attention import kernel as fa
    from repro_torch.hopper.mlstm_chunk import kernel as ml
    from repro_torch.hopper.rglru_scan import kernel as rg
    return {"flash_attention": fa, "mlstm_chunk": ml, "rglru_scan": rg}


def _tp_rank(rank, dev, refs):
    """One rank of a tensor-parallel phase: the (data 2, model 2) mesh
    over reference_mesh's four gloo ranks; each case's prefill step and,
    where it has one, train round on this rank's block, against the
    references at model 1 (``_tp_prepare``): the prefill's logits
    gathered by their spec, the round's blocks against the host round's.
    One rank at a time draws the whole parameters and keeps its blocks
    (four whole copies of deepseek's cut would not fit beside each
    other).  Returns the errors, the K2 / K3 / K4 launches, the seconds
    and bytes of the "model" group's collectives and the peak."""
    import gc
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.configs.base import ShapeConfig, TrainConfig
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import build_step, rank_args
    from repro_torch.models.init_utils import shape_generator
    from repro_torch.models.registry import build_model
    from repro_torch.sharding.rules import (gather_params, mesh_coordinate,
                                            params_specs, shard_params)
    from repro_torch.utils.tree import path_leaves, tree_map
    mesh = make_mesh((2, 2), ("data", "model"), device_type="cuda")
    coord = mesh_coordinate(mesh)
    assert coord == {"data": rank // 2, "model": rank % 2}, coord
    counters = _kernel_launches()
    out = {"coord": coord}
    for case, (cfg, prefill, train, steps) in refs["cases"].items():
        tol = TP_TOL[cfg.dtype]
        tcfg = TrainConfig(learning_rate=TP_LR[cfg.dtype],
                           local_steps_in_step=steps)
        b = build_step(cfg, ShapeConfig(*prefill), mesh)
        bt = (build_step(cfg, ShapeConfig(*train), mesh, tcfg=tcfg)
              if train is not None else None)
        model = build_model(cfg)
        spec = params_specs(model.init(shape_generator()), model.axes(),
                            mesh, mode="tp")
        for r in range(4):
            if r == rank:
                _, params, pbatch, batch, opt, _ = _tp_inputs(
                    torch, cfg, dev, prefill, train, steps)
                args = rank_args(b, (params, pbatch), mesh)
                if bt is not None:
                    local = shard_params(params, spec, mesh)
                del params, pbatch
                gc.collect()
                torch.cuda.empty_cache()
            dist.barrier()
        row = {}
        # ---- prefill (fsdp_tp: the embed dims gathered over "data") ----
        traffic, restore = _timed_collectives(torch, dist,
                                              mesh.get_group("model"))
        for k in counters.values():
            k.launches = 0
        routes = refs["routes"].get(case)
        calls = []
        try:
            with _routes(torch, record=calls):
                lg, wall = sync_time(torch, lambda: b.fn(*args))
        finally:
            restore()
        if routes is not None:
            # tokens of this rank's rows whose experts differ from model 1's
            row["prefill_route_flips"] = [
                int((np.sort(got, -1) != np.sort(want.reshape(
                    len(TP_ALPHA_U), -1, want.shape[-1])[coord["data"]],
                    -1)).any(-1).sum()) for got, want in zip(
                        calls, routes["prefill"])]
            row["prefill_routed_tokens"] = int(calls[0].shape[0])
        row["prefill_s"] = wall
        row["prefill_launches"] = {n: k.launches
                                   for n, k in counters.items()}
        row["prefill_model_collectives"] = traffic
        row["prefill_model_all_reduce"] = dict(traffic["all_reduce"])
        whole = gather_params({"x": lg}, {"x": ("data", None, "model")},
                              mesh)["x"]
        want = refs["prefill"][case]
        got = whole.float().cpu().numpy()
        row["prefill_max_abs_err"] = float(np.abs(got - want).max())
        row["prefill_scale"] = max(1.0, float(np.abs(want).max()))
        row["prefill_ok"] = bool(np.isfinite(got).all()) and row[
            "prefill_max_abs_err"] <= tol * row["prefill_scale"]
        del args, lg, whole
        gc.collect()
        torch.cuda.empty_cache()
        if bt is None:
            row["round_ok"] = True
            out[case] = row
            continue
        # ---- the train round ----
        init_local = tree_map(torch.clone, local)
        p1 = tree_map(lambda t: t.unsqueeze(0), local)
        s1 = tree_map(lambda t: t.unsqueeze(0), opt.init(local))
        del local
        rest = rank_args(bt, (None, None, batch,
                              np.asarray(TP_ALPHA_U, np.float32),
                              np.asarray(TP_ALPHA_U, np.float32)), mesh)[2:]
        del batch
        traffic, restore = _timed_collectives(torch, dist,
                                              mesh.get_group("model"))
        torch.cuda.reset_peak_memory_stats(dev)
        for k in counters.values():
            k.launches = 0
        replay = (routes["round"][coord["data"]]
                  if routes is not None else None)
        try:
            with _routes(torch, replay=replay):
                (pm, sm, mm), wall = sync_time(torch, lambda: bt.fn(
                    p1, s1, *rest))
        finally:
            restore()
        row["round_routes_pinned"] = replay is not None
        row["round_s"] = wall
        row["round_peak_GB"] = torch.cuda.max_memory_allocated(dev) / 1e9
        row["round_launches"] = {n: k.launches for n, k in counters.items()}
        row["round_model_collectives"] = traffic
        row["round_model_all_reduce"] = dict(traffic["all_reduce"])
        row["loss"] = float(mm["loss"])
        ref = np.load(f"{refs['dir']}/{case}_rank{rank}.npz")
        before = dict(path_leaves(init_local))
        worst, head_frozen, untouched_equal = 0.0, True, True
        margins, update_max, leaves, noise = [], 0.0, {}, {}
        finite = True
        writes = tcfg.local_steps_in_step + 1
        for p, t in path_leaves(pm):
            t = t[0]
            if p == "lm_head/w":
                head_frozen = bool(torch.equal(t, before[p]))
                continue
            b0 = before[p]
            if p == "embed/table":
                idx = torch.from_numpy(ref["embed_rows_idx"]).to(dev)
                keep = torch.ones(t.shape[0], dtype=torch.bool, device=dev)
                keep[idx] = False
                untouched_equal = bool(torch.equal(t[keep], b0[keep]))
                t, b0 = t[idx], b0[idx]
            got = (t.float() - b0.float()).cpu().numpy()
            want = ref[p]
            finite &= bool(np.isfinite(got).all() and np.isfinite(want).all())
            scale = float(np.abs(want).max())
            if p.endswith(TP_ZERO_GRAD):
                noise[p] = max(scale, float(np.abs(got).max()))
                continue
            ulp = float(ref[f"{p}@ulp"])
            limit = tol * scale + writes * ulp
            err = float(np.abs(got - want).max())
            leaves[p] = {"update_ulps": scale / ulp if ulp else 0.0,
                         "err_over_limit": err / limit if limit else (
                             math.inf if err else 0.0)}
            if limit == 0:                      # a leaf of zeros, unmoved
                worst = max(worst, leaves[p]["err_over_limit"])
                continue
            worst = max(worst, err / limit)
            margins.append(scale / limit)
            update_max = max(update_max, scale)
        # a leaf whose exact gradient is 0 moves by rounding noise alone
        row["round_zero_grad_noise"] = noise
        worst = max([worst, *(n / (tol * update_max)
                              for n in noise.values())])
        row["round_err_over_limit"] = worst
        row["round_update_max"] = update_max
        row["round_margin_median"] = float(np.median(margins))
        row["round_margin_min"] = min(margins)
        row["round_worst_leaves"] = sorted(
            leaves.items(), key=lambda kv: -kv[1]["err_over_limit"])[:3]
        row["round_unmoved"] = sorted(p for p, r in leaves.items()
                                      if r["update_ulps"] == 0)
        row["round_finite"] = finite
        row["round_ok"] = (finite and worst <= 1.0 and head_frozen
                           and untouched_equal
                           and row["round_margin_median"] >= TP_MARGIN
                           and abs(row["loss"] - refs["loss"][case])
                           <= tol * max(1.0, abs(refs["loss"][case])))
        row["head_frozen"], row["embed_untouched_rows_equal"] = (
            head_frozen, untouched_equal)
        out[case] = row
        del pm, sm, p1, s1, init_local, rest, ref
        gc.collect()
        torch.cuda.empty_cache()
    return out


def phase_tp_gemma(torch, np, refs, ranks):
    """tp_gemma's report: each rank's errors against model 1, the "model"
    group's ``all_reduce`` seconds and bytes, K2's launches (each case:
    the prefill's one a layer, the round's 2 local steps x layers x 2
    under remat)."""
    import shutil
    rows = {}
    for case, (cfg, _, _, _) in _tp_cases().items():
        n = attention_layers(cfg)
        rs = [r["tp"][case] for r in ranks]
        rows[case] = {
            "dtype": cfg.dtype, "layers": cfg.num_layers,
            "d_model": cfg.d_model, "vocab": cfg.padded_vocab,
            "tol": TP_TOL[cfg.dtype],
            "prefill_max_abs_err": [r["prefill_max_abs_err"] for r in rs],
            "prefill_scale": rs[0]["prefill_scale"],
            "lr": TP_LR[cfg.dtype],
            "round_err_over_limit": [r["round_err_over_limit"]
                                     for r in rs],
            "round_update_max": [r["round_update_max"] for r in rs],
            "round_margin_median": [r["round_margin_median"] for r in rs],
            "round_margin_min": [r["round_margin_min"] for r in rs],
            "round_worst_leaves": rs[0]["round_worst_leaves"],
            "round_unmoved": rs[0]["round_unmoved"],
            "head_frozen": [r["head_frozen"] for r in rs],
            "embed_untouched_rows_equal": [
                r["embed_untouched_rows_equal"] for r in rs],
            "loss": [r["loss"] for r in rs],
            "loss_model1": refs["loss"][case],
            "prefill_s": [r["prefill_s"] for r in rs],
            "round_s": [r["round_s"] for r in rs],
            "round_model1_host_s": refs["host_round_s"][case],
            "round_peak_GB": [r["round_peak_GB"] for r in rs],
            "host_round_peak_GB": refs["host_peak_GB"][case],
            "prefill_model_all_reduce": [r["prefill_model_all_reduce"]
                                         for r in rs],
            "round_model_all_reduce": [r["round_model_all_reduce"]
                                       for r in rs],
            "launches": {"prefill": [r["prefill_launches"][
                "flash_attention"] for r in rs],
                         "round": [r["round_launches"]["flash_attention"]
                                   for r in rs]},
            "launches_expected": {"prefill": n, "round": 2 * 2 * n},
            "ok": all(r["prefill_ok"] and r["round_ok"] for r in rs)}
    emit({"phase": "tp_gemma", "mesh": {"data": 2, "model": 2},
          "backend": "gloo", "prefill": TP_PREFILL, "train": TP_TRAIN,
          "alpha_u": TP_ALPHA_U, "cases": rows})
    shutil.rmtree(refs["dir"], ignore_errors=True)
    for case, row in rows.items():
        assert row["ok"], (case, row)
        assert row["launches"]["prefill"] == [
            row["launches_expected"]["prefill"]] * 4, row["launches"]
        assert row["launches"]["round"] == [
            row["launches_expected"]["round"]] * 4, row["launches"]
    return {case: row["launches"] for case, row in rows.items()}


def _tp_family_cases():
    """tp_families' cases: {arch/kind: (config, prefill, train or None,
    local steps)}; kind is the cut's dtype, "cut_float32" or the reduced
    config's "float32"."""
    from repro_torch.configs.registry import get_arch
    cases = {}
    for arch, layers in TP_FAMILY_LAYERS.items():
        whole = get_arch(arch)
        cut = dataclasses.replace(whole, num_layers=layers)
        if whole.encdec is not None:
            cut = dataclasses.replace(cut, encdec=dataclasses.replace(
                whole.encdec, num_encoder_layers=layers))
        small = zoo_config(arch, num_layers=max(2, len(whole.block_pattern)))
        train = TP_FAMILY_TRAIN.get(arch, TP_TRAIN)
        cases[f"{arch}/bfloat16"] = (
            cut, TP_PREFILL, train if arch in TP_FAMILY_BF16_ROUNDS else None,
            TP_FAMILY_STEPS["bfloat16"])
        if arch in TP_FAMILY_F32_CUTS:
            cases[f"{arch}/cut_float32"] = (
                dataclasses.replace(cut, dtype="float32"), TP_PREFILL, train,
                TP_FAMILY_STEPS["float32"])
        cases[f"{arch}/float32"] = (small, TP_PREFILL, train,
                                    TP_FAMILY_STEPS["float32"])
    return cases


@contextlib.contextmanager
def _routes(torch, record=None, replay=None):
    """``models.moe.route`` recording each call's experts (numpy, into
    ``record``) or replaying ``replay``'s, call by call: the experts given,
    their weights read from this run's router probabilities (renormalised
    with the 1e-9 clamp) and the load-balance loss from this run's
    probabilities over the given experts, as ``route`` computes them."""
    from repro_torch.models import moe
    route = moe.route
    calls = iter(replay or ())

    def wrapped(p, cfg, flat):
        out = route(p, cfg, flat)
        if record is not None:
            record.append(out[1].cpu().numpy())
        if replay is None:
            return out
        m = cfg.moe
        probs = torch.softmax(flat.to(torch.float32) @ p["router"]["w"],
                              dim=-1)
        top_e = torch.from_numpy(next(calls)).to(flat.device)
        top_w = probs.gather(-1, top_e)
        top_w = top_w / top_w.sum(-1, keepdim=True).clamp_min(1e-9)
        e = top_e.reshape(-1)
        counts = torch.zeros(m.num_experts, dtype=torch.int64,
                             device=e.device).scatter_add_(
            0, e, torch.ones_like(e))
        share = counts.to(torch.float32) / (flat.shape[0] * m.top_k)
        aux = m.num_experts * (share * probs.mean(dim=0)).sum()
        return top_w, top_e, counts, aux

    moe.route = wrapped
    try:
        yield
    finally:
        moe.route = route


def _tp_family_file(case: str) -> str:
    return case.replace("/", "_")


def phase_tp_families_prepare(torch, np):
    """tp_families' references at model 1 on the card (``_tp_prepare``),
    the case names made file names."""
    cases = {_tp_family_file(c): v for c, v in _tp_family_cases().items()}
    return _tp_prepare(torch, np, "tp_families", cases)


def _tp_expected(cfg) -> dict:
    """K2's, K3's and K4's launches of a prefill of ``cfg`` on every rank
    (the local heads, width or experts run the same layers)."""
    from repro_torch.configs.base import MLSTM, RGLRU
    kinds = cfg.layer_kinds()
    return {"flash_attention": attention_layers(cfg),
            "mlstm_chunk": sum(k == MLSTM for k in kinds),
            "rglru_scan": sum(k == RGLRU for k in kinds)}


def phase_tp_families(torch, np, refs, ranks):
    """tp_families' report: each case's errors on every rank against model
    1, the "model" group's collectives (calls, bytes, seconds, by kind)
    and each rank's K2 / K3 / K4 launches against the count reckoned for
    the local shapes: a prefill's one a layer of the kernel's kind, a
    round's 2 local steps x 2 (remat "full" runs the forward again)."""
    import shutil
    rows = {}
    for case, (cfg, prefill, train, steps) in refs["cases"].items():
        rs = [r["tp_families"][case] for r in ranks]
        pre = _tp_expected(cfg)
        row = {
            "arch": cfg.name, "dtype": cfg.dtype, "layers": cfg.num_layers,
            "d_model": cfg.d_model, "vocab": cfg.padded_vocab,
            "tol": TP_TOL[cfg.dtype], "prefill": prefill, "train": train,
            "local_steps": steps,
            "prefill_max_abs_err": [r["prefill_max_abs_err"] for r in rs],
            "prefill_scale": rs[0]["prefill_scale"],
            "prefill_s": [r["prefill_s"] for r in rs],
            "prefill_model_collectives": [r["prefill_model_collectives"]
                                          for r in rs],
            "launches": {"prefill": [r["prefill_launches"] for r in rs]},
            "launches_expected": {"prefill": pre},
            "prefill_route_flips": [r.get("prefill_route_flips")
                                    for r in rs],
            "prefill_routed_tokens": rs[0].get("prefill_routed_tokens"),
            "prepare_s": refs["prepare_s"][case]}
        if train is not None:
            k = steps * 2
            row.update({
                "lr": TP_LR[cfg.dtype],
                "round_err_over_limit": [r["round_err_over_limit"]
                                         for r in rs],
                "round_update_max": [r["round_update_max"] for r in rs],
                "round_margin_median": [r["round_margin_median"]
                                        for r in rs],
                "round_margin_min": [r["round_margin_min"] for r in rs],
                "round_worst_leaves": rs[0]["round_worst_leaves"],
                "round_unmoved": rs[0]["round_unmoved"],
                "round_finite": [r["round_finite"] for r in rs],
                "round_routes_pinned": rs[0]["round_routes_pinned"],
                "round_zero_grad_noise": rs[0]["round_zero_grad_noise"],
                "head_frozen": [r["head_frozen"] for r in rs],
                "embed_untouched_rows_equal": [
                    r["embed_untouched_rows_equal"] for r in rs],
                "loss": [r["loss"] for r in rs],
                "loss_model1": refs["loss"][case],
                "round_s": [r["round_s"] for r in rs],
                "round_model1_host_s": refs["host_round_s"][case],
                "round_peak_GB": [r["round_peak_GB"] for r in rs],
                "host_round_peak_GB": refs["host_peak_GB"][case],
                "round_model_collectives": [r["round_model_collectives"]
                                            for r in rs]})
            row["launches"]["round"] = [r["round_launches"] for r in rs]
            row["launches_expected"]["round"] = {n: k * c
                                                 for n, c in pre.items()}
        row["ok"] = all(r["prefill_ok"] and r["round_ok"] for r in rs)
        rows[case] = row
    emit({"phase": "tp_families", "mesh": {"data": 2, "model": 2},
          "backend": "gloo", "alpha_u": TP_ALPHA_U, "cases": rows})
    shutil.rmtree(refs["dir"], ignore_errors=True)
    for case, row in rows.items():
        assert row["ok"], (case, row)
        for kind, want in row["launches_expected"].items():
            assert row["launches"][kind] == [want] * 4, (case, kind, row[
                "launches"])
    return {name: {case: {kind: [r[name] for r in row["launches"][kind]]
                          for kind in row["launches"]}
                   for case, row in rows.items()}
            for name in ("flash_attention", "mlstm_chunk", "rglru_scan")}


def phase_dryrun(torch):
    """The port's dry run on this machine: gemma3-12b whole x the four
    shapes x the (16, 16) mesh, and deepseek-v2-236b whole (MoE and MLA,
    the zoo's largest) at train_4k on it, over a fake group of 256 ranks,
    on fake CUDA tensors (K2 through its fake registration; nothing
    launched).  Each record's three terms, the traced FLOPs against the
    analytic ones, the collective bytes a rank by kind and mesh dim
    against the analytic coll_tp / coll_edge, the traced peak and the
    trace's seconds."""
    from repro_torch.configs.registry import supports_shape
    from repro_torch.configs.shapes import SHAPES
    from repro_torch.hopper.flash_attention import kernel as fa
    from repro_torch.launch import dryrun
    out_dir = ROOT / "build" / "dryrun_torch"
    rows = {}
    before = fa.launches
    runs = [(DRYRUN_ARCH, name) for name in SHAPES
            if supports_shape(DRYRUN_ARCH, name)] + [DRYRUN_MOE]
    for arch, name in runs:
        rec = dryrun.run_one(arch, name, "single", out_dir=str(out_dir),
                             verbose=False, local_steps=(
                                 DRYRUN_MOE_LOCAL_STEPS
                                 if (arch, name) == DRYRUN_MOE else None))
        name = name if arch == DRYRUN_ARCH else f"{arch}/{name}"
        c = rec["collective_detail"]
        rows[name] = {
            "trace_device": rec["trace_device"],
            "compute_s": rec["compute_s"], "memory_s": rec["memory_s"],
            "collective_s": rec["collective_s"], "dominant": rec["dominant"],
            "flops_per_chip": rec["flops_per_chip"],
            "traced_flops_per_chip": rec["traced_flops_per_chip"],
            "traced_over_analytic": rec["traced_flops_over_analytic"],
            "traced_collective_bytes_by_dim": {
                d: {k: v for k, v in r.items() if k != "counts" and v}
                for d, r in c["by_dim"].items()},
            "traced_collective_counts_by_dim": {
                d: {k: v for k, v in r["counts"].items() if v}
                for d, r in c["by_dim"].items()},
            "analytic_coll": {k: rec["analytic_detail"].get(k) for k in
                              ("coll_tp", "coll_edge", "coll_pod",
                               "coll_fsdp") if k in rec["analytic_detail"]},
            "peak_memory_GB": rec["peak_memory_bytes"] / 1e9,
            "trace_s": rec["trace_s"]}
    emit({"phase": "dryrun", "arch": DRYRUN_ARCH, "moe": DRYRUN_MOE,
          "mesh": "single (16, 16)", "chips": 256, "records": rows,
          "k2_launches_during_trace": fa.launches - before})
    assert len(rows) == 5, sorted(rows)
    assert all(r["trace_device"] == "cuda" for r in rows.values())
    assert fa.launches == before
    for r in rows.values():
        assert r["traced_flops_per_chip"] > 0 and r["peak_memory_GB"] > 0
    return rows



# ------------------------------------------------------------- the examples --
# every examples/port_<name>.py, called in this process at the reference
# example's own arguments (none: the card by default); the scheduler-only
# ones again in a child process that sees no card
EXAMPLES_SCHEDULER_ONLY = ("faulty_phsfl", "pipelined_phsfl",
                           "device_aware_cut")
EXAMPLES_FEDSIM = ("personalized_federation", "wireless_phsfl",
                   "adaptive_cut", "compressed_phsfl")
EXAMPLES_LAUNCHERS = ("quickstart", "serve_personalized",
                      "multipod_dryrun_demo")
EXAMPLE_NUMBER = re.compile(r"[-+]?\d[\d,]*(?:\.\d+)?(?:e[-+]?\d+)?")


def _load_file(path: Path):
    """A script of the checkout (an example, a tool) as a module."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        f"_{path.parent.name}_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _load_example(name):
    return _load_file(ROOT / "examples" / f"port_{name}.py")


@contextlib.contextmanager
def _fd_stdout(path):
    """The process's stdout, file descriptor 1 included (a child process
    inherits it), written to ``path`` inside the block."""
    sys.stdout.flush()
    saved = os.dup(1)
    with open(path, "wb") as f:
        os.dup2(f.fileno(), 1)
    try:
        yield
    finally:
        sys.stdout.flush()
        os.dup2(saved, 1)
        os.close(saved)


def _printed_numbers(text) -> list:
    """The numbers of each printed line that has any."""
    rows = []
    for line in text.splitlines():
        nums = [float(n.replace(",", "")) for n in
                EXAMPLE_NUMBER.findall(line)]
        if nums:
            rows.append(nums)
    return rows


def _scheduler_examples_on_cpu() -> dict:
    """The scheduler-only examples' stdout from a child process that sees
    no card (``CUDA_VISIBLE_DEVICES`` empty)."""
    code = ("import contextlib, io, json, sys\n"
            f"sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]\n"
            "import torch\n"
            "assert not torch.cuda.is_available()\n"
            "from chip_smoke import _load_example\n"
            "out = {}\n"
            f"for name in {EXAMPLES_SCHEDULER_ONLY!r}:\n"
            "    buf = io.StringIO()\n"
            "    with contextlib.redirect_stdout(buf):\n"
            "        _load_example(name).main([])\n"
            "    out[name] = buf.getvalue()\n"
            "print(json.dumps(out))\n")
    run = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert run.returncode == 0, run.stderr[-4000:]
    return json.loads(run.stdout.strip().splitlines()[-1])


def _resume_args() -> list:
    """The Makefile's ``RESUME_ARGS`` (resume-smoke and trace-smoke)."""
    import shlex
    lines = (ROOT / "Makefile").read_text().splitlines()
    start = next(i for i, line in enumerate(lines)
                 if line.startswith("RESUME_ARGS ="))
    text = []
    for line in lines[start:]:
        text.append(line.rstrip("\\").strip())
        if not line.endswith("\\"):
            break
    return shlex.split(" ".join(text).partition("=")[2])


def example_launches_expected() -> dict:
    """Each example's K1-K4 launches, reckoned from the code: K1 twice a
    minibatch step (the cut's activations and gradients, all clients in
    one launch) and once a client-block leaf an edge round (the offload)
    in compressed_phsfl's two int8 runs (2 rounds x kappa1 2 x (kappa0 5
    x 5 minibatches x 2 + leaves), conv1: 2 leaves, fc1: 6); K2 once an
    attention layer a trunk forward in quickstart (gemma3-12b reduced,
    train()'s forwards at 5 rounds x 4 clients x 2 local steps); K3 once
    an mLSTM layer in serve_personalized's one head-bank forward
    (xlstm-350m reduced); none elsewhere (the dry run's trace runs on
    fake tensors in its own process)."""
    from repro_torch.configs.base import MLSTM
    from repro_torch.configs.registry import get_arch
    from repro_torch.models.cnn import CUT_CANDIDATES, client_keys_for
    zero = {"quantize": 0, "flash_attention": 0, "mlstm_chunk": 0,
            "rglru_scan": 0}
    out = {name: dict(zero) for name in (
        EXAMPLES_SCHEDULER_ONLY + EXAMPLES_FEDSIM + EXAMPLES_LAUNCHERS)}
    out["compressed_phsfl"]["quantize"] = sum(
        2 * 2 * (5 * 5 * 2 + 2 * len(client_keys_for(cut)))
        for cut in (CUT_CANDIDATES[0], CUT_CANDIDATES[-1]))
    gemma = get_arch("gemma3-12b").reduced()
    out["quickstart"]["flash_attention"] = _train_forwards(
        dict(rounds=5, clients=4, local_steps=2)) * attention_layers(gemma)
    out["serve_personalized"]["mlstm_chunk"] = sum(
        k == MLSTM for k in get_arch("xlstm-350m").reduced().layer_kinds())
    return out


def phase_examples(torch, kernels):
    """Every ``examples/port_*.py``'s ``main`` in this process on the card
    at the reference example's own arguments, counts set to 0 just before
    each and read just after: one JSON line an example with its wall
    seconds, launches and the numbers it printed.  Then the Makefile's
    port-resume-smoke (three ``launch.train`` runs with ``RESUME_ARGS``,
    the state directories through ``tools/port_ckpt_diff.py``) and
    port-trace-smoke (the ``--trace-dir`` run through
    ``tools/check_trace.py``).  Fails unless each example launches what
    ``example_launches_expected`` reckons, the scheduler-only examples
    print what they print in a child process without a card, the PHSFL
    row of personalized_federation shows a gain above 0, the resumed
    state is bit-identical and the trace directory passes."""
    expected = example_launches_expected()
    rows = {}
    with tempfile.TemporaryDirectory() as d:
        for name in (EXAMPLES_SCHEDULER_ONLY + EXAMPLES_FEDSIM
                     + EXAMPLES_LAUNCHERS):
            mod = _load_example(name)
            path = Path(d) / f"{name}.txt"
            reset_counts(kernels)
            with _fd_stdout(path):
                ret, wall = sync_time(torch, lambda: mod.main([]))
            counts = read_counts(kernels)
            text = path.read_text()
            rows[name] = {"wall_s": wall, "launches": counts,
                          "launches_expected": expected[name],
                          "numbers": _printed_numbers(text), "text": text}
            if name == "multipod_dryrun_demo":
                rows[name]["exit_code"] = ret
        cpu = _scheduler_examples_on_cpu()
        args = _resume_args()
        from repro_torch.configs.base import MLSTM
        from repro_torch.configs.registry import get_arch
        from repro_torch.launch.train import main as train_main
        from repro_torch.launch.train import parse_args
        flags = parse_args(args)
        smoke_expected = _train_forwards(vars(flags)) * sum(
            k == MLSTM for k in get_arch(flags.arch).reduced().layer_kinds())
        smoke = {}
        runs = (("full", ["--ckpt-dir", f"{d}/resume/full"]),
                ("killed", ["--ckpt-dir", f"{d}/resume/killed",
                            "--abort-after", "1"]),
                ("resumed", ["--ckpt-dir", f"{d}/resume/killed",
                             "--resume"]),
                ("trace", ["--trace-dir", f"{d}/trace"]))
        for run, extra in runs:
            reset_counts(kernels)
            with _fd_stdout(Path(d) / f"{run}.txt"):
                res, wall = sync_time(torch, lambda: train_main(
                    [*args, "--device", "cuda", *extra]))
            smoke[run] = {"wall_s": wall, "launches": read_counts(kernels),
                          "final_loss": res.final_loss,
                          "aborted_after": res.aborted_after}
        with _fd_stdout(Path(d) / "diff.txt"):
            diff_rc = _load_file(ROOT / "tools" / "port_ckpt_diff.py").main(
                [f"{d}/resume/full/state", f"{d}/resume/killed/state"])
        with _fd_stdout(Path(d) / "check.txt"):
            trace_rc = _load_file(ROOT / "tools" / "check_trace.py").main(
                [f"{d}/trace"])
        diff_text = (Path(d) / "diff.txt").read_text().strip()
        trace_text = (Path(d) / "check.txt").read_text().strip()
    for name, row in rows.items():
        same_as_cpu = (row["text"] == cpu[name]
                       if name in EXAMPLES_SCHEDULER_ONLY else None)
        emit({"phase": "examples", "example": name,
              "argv": [], "wall_s": row["wall_s"],
              "launches": row["launches"],
              "launches_expected": row["launches_expected"],
              **({"exit_code": row["exit_code"]} if "exit_code" in row
                 else {}),
              **({"same_as_cpu": same_as_cpu} if same_as_cpu is not None
                 else {}),
              "printed_numbers": row["numbers"]})
    emit({"phase": "examples", "example": "port-resume-smoke",
          "resume_args": args, "runs": {k: v for k, v in smoke.items()
                                        if k != "trace"},
          "mlstm_launches_expected": smoke_expected,
          "port_ckpt_diff_rc": diff_rc, "port_ckpt_diff": diff_text})
    emit({"phase": "examples", "example": "port-trace-smoke",
          "resume_args": args, "run": smoke["trace"],
          "mlstm_launches_expected": smoke_expected,
          "check_trace_rc": trace_rc, "check_trace": trace_text})
    for name, row in rows.items():
        assert row["launches"] == row["launches_expected"], (name, row[
            "launches"], row["launches_expected"])
    for name in EXAMPLES_SCHEDULER_ONLY:
        assert rows[name]["text"] == cpu[name], name
        assert rows[name]["text"].count("\n") > 5, name
    phsfl = [r for r in rows["personalized_federation"]["text"].splitlines()
             if r.startswith("phsfl")]
    assert len(phsfl) == 1 and float(phsfl[0].split()[-1]) > 0, phsfl
    assert rows["multipod_dryrun_demo"]["exit_code"] == 0
    assert "ok chips=512" in rows["multipod_dryrun_demo"]["text"]
    for name in EXAMPLES_FEDSIM + ("quickstart", "serve_personalized"):
        assert all(math.isfinite(v) for line in rows[name]["numbers"]
                   for v in line), name
    k3 = {run: r["launches"]["mlstm_chunk"] for run, r in smoke.items()}
    assert (k3["full"] == k3["trace"] == k3["killed"] + k3["resumed"]
            == smoke_expected > 0), (k3, smoke_expected)
    assert all(r["launches"]["mlstm_chunk"] == sum(r["launches"].values())
               for r in smoke.values()), smoke
    assert smoke["killed"]["aborted_after"] == 1
    assert smoke["full"]["aborted_after"] is None
    assert smoke["full"]["final_loss"] == smoke["resumed"]["final_loss"]
    assert diff_rc == 0 and "bit-identical" in diff_text, diff_text
    assert trace_rc == 0, trace_text
    return {name: row["launches"] for name, row in rows.items()}


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.device import resolve_device
    from repro_torch.hopper.flash_attention import kernel as fa_kernel
    from repro_torch.hopper.flash_attention import ops as fa_ops
    from repro_torch.hopper.flash_attention import ref as fa_ref
    from repro_torch.hopper.mlstm_chunk import kernel as ml_kernel
    from repro_torch.hopper.mlstm_chunk import ops as ml_ops
    from repro_torch.hopper.mlstm_chunk import ref as ml_ref
    from repro_torch.hopper.quantize import kernel, ops, ref
    from repro_torch.hopper.rglru_scan import kernel as rg_kernel
    from repro_torch.hopper.rglru_scan import ops as rg_ops
    from repro_torch.hopper.rglru_scan import ref as rg_ref
    kernels = {"quantize": kernel, "flash_attention": fa_kernel,
               "mlstm_chunk": ml_kernel, "rglru_scan": rg_kernel}

    resolve_device("cuda")               # float32 numerics on the card
    phase_device(torch)
    phase_build(kernels)
    max_err = phase_check(torch, ops, ref)
    flash_err = phase_check_flash(torch, fa_ops, fa_ref)
    timing = phase_time(torch, ops, ref)
    flash_timing = phase_time_flash(torch, fa_ops, fa_ref)
    zoo_timing = {
        "deepseek-v2-236b": phase_time_flash(
            torch, fa_ops, fa_ref, m=FLASH_MLA, layers={"global": 0},
            arch="deepseek-v2-236b")["global"],
        "olmoe-1b-7b": phase_time_flash(
            torch, fa_ops, fa_ref, m=FLASH_OLMOE, layers={"global": 0},
            arch="olmoe-1b-7b")["global"]}
    seamless_timing = phase_time_flash(
        torch, fa_ops, fa_ref, m=FLASH_SEAMLESS, layers={"global": 0},
        arch="seamless-m4t-medium")["global"]
    flash_backward = phase_check_flash_backward(torch, fa_ops)
    phase_reference(np)
    launches, sim = phase_fedsim(torch, np, kernels)
    phase_profile(torch, sim)
    data = sim.data
    del sim
    phase_check_cohort(torch, np)
    phase_cohort(torch, np)
    phase_reference_wireless(np)
    wireless_launches_, wireless_run = phase_fedsim_wireless(
        torch, np, kernels, data)
    wireless_counts = {"fedsim_wireless": wireless_launches_}
    phase_fedsim_repeat(torch, np, data, wireless_run)
    telemetry_counts = {"fedsim_telemetry": phase_fedsim_telemetry(
        torch, np, kernels, data, wireless_run)}
    del wireless_run
    phase_genie(torch, np, data)
    del data
    phase_reference_serve(np)
    flash_launches = phase_serve(torch, kernels)
    mlstm_err = phase_check_mlstm(torch, ml_ops, ml_ref)
    mlstm_timing = phase_time_mlstm(torch, ml_ops, ml_ref, ml_kernel)
    phase_reference_serve_xlstm(torch, np, kernels)
    mlstm_launches = phase_serve_xlstm(torch, kernels)
    rglru_err = phase_check_rglru(torch, rg_ops, rg_ref)
    rglru_timing = phase_time_rglru(torch, rg_ops, rg_ref)
    mqa_timing = phase_time_flash(torch, fa_ops, fa_ref, m=FLASH_MQA,
                                  layers={"local": RGLRU_WINDOW},
                                  arch="recurrentgemma-2b")["local"]
    probes = phase_check_probes(
        torch, kernels, fa_ops, ml_ops, ops, rg_ops,
        {"quantize": timing["kernel_ms"],
         "flash_attention": flash_timing["global"]["kernel_ms"],
         "mlstm_chunk": mlstm_timing["bfloat16"]["kernel_ms"],
         "rglru_scan": rglru_timing["kernel_ms"]})
    phase_reference_serve_rglru(torch, np, kernels)
    rglru_launches, rg_flash_launches = phase_serve_rglru(torch, kernels)
    train_counts = {"reference_train": phase_reference_train(torch, np,
                                                             kernels)}
    train_counts["reference_train_remat"] = phase_reference_train_remat(
        torch, np, kernels)
    train_counts["train_xlstm"] = phase_train_xlstm(
        torch, kernels, layers=TRAIN_XLSTM_LAYERS)
    train_counts["train_xlstm_2048"] = phase_train_xlstm(
        torch, kernels, TRAIN_XLSTM_CONTEXT, "train_xlstm_2048",
        layers=TRAIN_XLSTM_CONTEXT_LAYERS,
        profile=False)
    train_counts["train_rglru"] = phase_train_rglru(torch, kernels)
    phase_resume_train(torch, np)
    wireless_counts["train_wireless"] = phase_train_wireless(torch, np,
                                                             kernels)
    telemetry_counts["train_telemetry"] = phase_train_telemetry(torch, np,
                                                                kernels)
    zoo_rows = phase_reference_zoo(torch, np, kernels)
    zoo_serving = {"serve_olmoe": phase_serve_olmoe(torch, kernels),
                   "serve_deepseek": phase_serve_deepseek(torch, kernels)}
    train_counts["train_qwen2vl"] = phase_train_zoo(
        torch, kernels, "qwen2-vl-7b", "train_qwen2vl")
    train_counts["train_olmoe"] = phase_train_zoo(
        torch, kernels, "olmoe-1b-7b", "train_olmoe")
    encdec_launches = phase_reference_encdec(torch, np, kernels)
    seamless_serving = phase_serve_seamless(torch, kernels)
    for policy, counts in phase_train_seamless(torch, kernels).items():
        train_counts[f"train_seamless_{policy}"] = counts
    mesh_counts = {"mesh_nccl": phase_mesh_nccl(torch, np, kernels)}
    launch_tools = {"steps_gemma": phase_steps_gemma(torch, np, kernels)}
    tp_refs = phase_tp_gemma_prepare(torch, np)
    family_refs = phase_tp_families_prepare(torch, np)
    mesh_counts["reference_mesh"], ranks = phase_reference_mesh(
        torch, np, kernels, tp_refs, family_refs)
    launch_tools["tp_gemma"] = phase_tp_gemma(torch, np, tp_refs, ranks)
    tp_families = phase_tp_families(torch, np, family_refs, ranks)
    del ranks
    mesh_counts["train_mesh_seamless"] = phase_train_mesh_seamless(
        torch, np, kernels)
    phase_dryrun(torch)
    example_counts = phase_examples(torch, kernels)

    def examples(name):
        """Each port example's launches of one kernel."""
        return {ex: counts[name] for ex, counts in example_counts.items()}

    def mesh_launches(name):
        """Each mesh phase's launches of one kernel: mesh_nccl's by run,
        the spawned phases' by rank (they count K2 only)."""
        nccl = {run: counts[name]
                for run, counts in mesh_counts["mesh_nccl"].items()}
        return {"mesh_nccl": nccl, **{
            phase: counts[name] for phase, counts in mesh_counts.items()
            if name in counts and phase != "mesh_nccl"}}

    def train_launches(name):
        """Each training phase's launches of one kernel, as it read them."""
        return {phase: counts[name] for phase, counts in train_counts.items()}

    def wireless_launches(name):
        """Each network-mode phase's launches of one kernel."""
        return {phase: counts[name]
                for phase, counts in wireless_counts.items()}

    def telemetry(name):
        """Each telemetry phase's launches of one kernel, and its probe
        at the main-path shape (check_probes)."""
        row = probes[name]
        return {"launches": {phase: counts[name] for phase, counts
                             in telemetry_counts.items()},
                "probed_wall_ms": row["probed_wall_ms"],
                "event_ms": row["event_ms"]}

    g, loc = flash_timing["global"], flash_timing["local"]
    mb = mlstm_timing["bfloat16"]
    emit({"kernels": [{
        "name": "quantize", "route": "cuda",
        "source": "src/repro_torch/hopper/quantize/csrc/quantize.cu",
        "replaces": "src/repro/kernels/quantize/kernel.py:40",
        "launches": launches, "train_launches": train_launches("quantize"),
        "wireless_launches": wireless_launches("quantize"),
        "telemetry": telemetry("quantize"),
        "examples_launches": examples("quantize"),
        "equal": True, "max_abs_err": max_err,
        "ms": timing["kernel_ms"], "kernel_ms": timing["kernel_ms"],
        "plain_ms": timing["plain_ms"], "bound_ms": timing["bound_ms"],
        "bound_by": "bytes", "library_ms": None}, {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/hopper/flash_attention/csrc/"
                  "flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:98",
        "launches": flash_launches,
        "train_launches": train_launches("flash_attention"),
        "mesh_launches": mesh_launches("flash_attention"),
        "launch_tools_launches": {
            "steps_gemma": {kind: c["flash_attention"] for kind, c in
                            launch_tools["steps_gemma"].items()},
            "tp_gemma_per_rank": launch_tools["tp_gemma"],
            "tp_families_per_rank": tp_families["flash_attention"]},
        "wireless_launches": wireless_launches("flash_attention"),
        "telemetry": telemetry("flash_attention"),
        "examples_launches": examples("flash_attention"),
        "within_tolerance": True,
        "tolerance": FLASH_TOL, "max_abs_err": flash_err,
        "shape": "global layer: q (6,2048,16,256), k/v (6,2048,8,256) "
                 "bf16, causal",
        "ms": g["kernel_ms"], "kernel_ms": g["kernel_ms"],
        "plain_ms": g["plain_ms"], "bound_ms": g["bound_ms"],
        "bound_by": g["bound_by"], "library_ms": g["library_ms"],
        "local": {k: loc[k] for k in ("window", "kernel_ms", "plain_ms",
                                      "bound_ms", "bound_by",
                                      "library_ms")},
        "backward_s8192": {
            f"window_{r['window']}": {k: r[k] for k in (
                "blocked_peak_GB", "dense_peak_GB", "grad_max_abs_err")}
            for r in flash_backward},
        "recurrentgemma_local": {
            "shape": "q (6,2048,10,256), k/v (6,2048,1,256) bf16, window "
                     "2048", "launches": rg_flash_launches,
            **{k: mqa_timing[k] for k in ("kernel_ms", "plain_ms",
                                          "bound_ms", "bound_by",
                                          "library_ms")}},
        "zoo": {
            "launches": {
                "reference_zoo": {a: r["loss_launches"]
                                  for a, r in zoo_rows.items()},
                **{p: r["launches"]["flash_attention"]
                   for p, r in zoo_serving.items()}},
            "head_widths_qv": {p: r["flash_head_widths_qv"]
                               for p, r in zoo_serving.items()},
            **{arch: {"shape": "q (%d,%d,%d,%d), k (%d,%d,%d,%d), v "
                               "width %d, bf16, causal" % (
                                   *t["bshkd"][:3], t["bshkd"][4],
                                   *t["bshkd"][:2], t["bshkd"][3],
                                   t["bshkd"][4], t["dv"]),
                      **{k: t[k] for k in ("kernel_ms", "plain_ms",
                                           "bound_ms", "bound_by",
                                           "library_ms",
                                           "library_kernels")}}
               for arch, t in zoo_timing.items()}},
        "seamless": {
            "launches": {
                "reference_encdec": encdec_launches,
                "serve_seamless":
                    seamless_serving["launches"]["flash_attention"],
                "train_seamless": {
                    policy: train_counts[f"train_seamless_{policy}"][
                        "flash_attention"]
                    for policy in ("none", "full", "dots")}},
            "head_widths_qv": seamless_serving["flash_head_widths_qv"],
            "shape": "decoder: q, k, v (6,2048,16,64) bf16, causal",
            **{k: seamless_timing[k] for k in (
                "kernel_ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "library_kernels")}}}, {
        "name": "mlstm_chunk", "route": "cuda",
        "source": "src/repro_torch/hopper/mlstm_chunk/csrc/mlstm_chunk.cu",
        "replaces": "src/repro/kernels/mlstm_chunk/kernel.py:77",
        "launches": mlstm_launches,
        "train_launches": train_launches("mlstm_chunk"),
        "mesh_launches": mesh_launches("mlstm_chunk"),
        "launch_tools_launches": {
            "tp_families_per_rank": tp_families["mlstm_chunk"]},
        "wireless_launches": wireless_launches("mlstm_chunk"),
        "telemetry": telemetry("mlstm_chunk"),
        "examples_launches": examples("mlstm_chunk"),
        "within_tolerance": True,
        "tolerance": MLSTM_TOL, "max_abs_err": mlstm_err,
        "shape": "q, k, v (6,2048,4,512) bf16, li/lf (6,2048,4) float32",
        "ms": mb["kernel_ms"], "kernel_ms": mb["kernel_ms"],
        "plain_ms": mb["plain_ms"], "bound_ms": mb["bound_ms"],
        "bound_by": mb["bound_by"], "library_ms": None,
        "pass_ms": mb["pass_ms"],
        "float32": {k: mlstm_timing["float32"][k] for k in (
            "kernel_ms", "plain_ms", "bound_ms", "bound_by")}}, {
        "name": "rglru_scan", "route": "cuda",
        "source": "src/repro_torch/hopper/rglru_scan/csrc/rglru_scan.cu",
        "replaces": "src/repro/kernels/rglru_scan/kernel.py:46",
        "launches": rglru_launches,
        "train_launches": train_launches("rglru_scan"),
        "launch_tools_launches": {
            "tp_families_per_rank": tp_families["rglru_scan"]},
        "wireless_launches": wireless_launches("rglru_scan"),
        "telemetry": telemetry("rglru_scan"),
        "examples_launches": examples("rglru_scan"),
        "within_tolerance": True,
        "tolerance": RGLRU_TOL, "max_abs_err": rglru_err,
        "shape": "log_a, b (6,2048,2560) float32, h0 (6,2560) float32",
        "ms": rglru_timing["kernel_ms"],
        "kernel_ms": rglru_timing["kernel_ms"],
        "plain_ms": rglru_timing["plain_ms"],
        "bound_ms": rglru_timing["bound_ms"],
        "bound_by": rglru_timing["bound_by"], "library_ms": None}]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
