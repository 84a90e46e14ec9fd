"""Config dataclasses: the model zoo's ``ModelConfig``, the PHSFL
hierarchy and training configs, and the wireless scenario.

Copies of ``ModelConfig`` (with its block kinds and sub-configs),
``HierarchyConfig``, ``TrainConfig``, ``FaultConfig`` and
``WirelessConfig`` from ``repro.configs.base`` (the
port imports nothing of the reference package).  Fields the port does not
use yet (the sub-configs of block kinds it cannot run, the datacenter-mode
knobs) stay, so one config means the same run on both sides.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional


# --------------------------------------------------------------------------
# Block kinds (per-layer), cycled from ``ModelConfig.block_pattern``
# --------------------------------------------------------------------------
ATTN = "attn"                # global full attention
LOCAL_ATTN = "local_attn"    # sliding-window attention
MLA_ATTN = "mla"             # DeepSeek-V2 multi-head latent attention
RGLRU = "rglru"              # RecurrentGemma RG-LRU recurrent block
SLSTM = "slstm"              # xLSTM sLSTM block
MLSTM = "mlstm"              # xLSTM mLSTM block

BLOCK_KINDS = (ATTN, LOCAL_ATTN, MLA_ATTN, RGLRU, SLSTM, MLSTM)

RECURRENT_KINDS = (RGLRU, SLSTM, MLSTM)  # O(1)-state decode blocks


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared_experts: int = 0
    d_ff_shared: int = 0
    router_aux_loss: float = 0.01
    # layers whose FFN is dense instead of MoE (e.g. deepseek first layer)
    first_dense_layers: int = 0
    d_ff_dense: int = 0


@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V2 multi-head latent attention [arXiv:2405.04434]."""
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class EncDecConfig:
    """Encoder-decoder (Seamless-M4T backbone)."""
    num_encoder_layers: int = 12
    # encoder input is a stubbed modality frontend: precomputed frame embeddings
    max_source_len: int = 1024


@dataclass(frozen=True)
class VLMConfig:
    """Vision frontend stub (Qwen2-VL): patch embeddings are precomputed."""
    num_patch_tokens: int = 1024
    mrope_sections: tuple[int, int, int] = (16, 24, 24)  # t/h/w split of head_dim/2


@dataclass(frozen=True)
class XLSTMConfig:
    """xLSTM block geometry [arXiv:2405.04517]."""
    proj_factor_mlstm: float = 2.0
    proj_factor_slstm: float = 1.3333333
    conv_kernel: int = 4
    num_heads: int = 4


@dataclass(frozen=True)
class RGLRUConfig:
    """RecurrentGemma RG-LRU block [arXiv:2402.19427]."""
    lru_width: int = 0          # 0 -> d_model
    conv_kernel: int = 4
    block_width_multiplier: float = 3.0  # gated-MLP expansion in recurrent block


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    block_pattern: tuple[str, ...] = (ATTN,)
    # attention details
    rope_theta: float = 10000.0
    local_rope_theta: float = 10000.0
    sliding_window: int = 0          # used by LOCAL_ATTN layers
    attn_logit_softcap: float = 0.0
    final_logit_softcap: float = 0.0
    attn_bias: bool = False
    qk_norm: bool = False
    # sub-configs
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    encdec: Optional[EncDecConfig] = None
    vlm: Optional[VLMConfig] = None
    xlstm: Optional[XLSTMConfig] = None
    rglru: Optional[RGLRUConfig] = None
    # norm / act / embedding
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    act: str = "silu"                # silu | gelu
    tie_embeddings: bool = False
    embed_scale: bool = False        # gemma-style sqrt(d_model) embedding scale
    # ---- PHSFL split (the paper's technique) ----
    n_client_layers: int = 2         # blocks in the client-side model w_0
    head_name: str = "lm_head"       # pytree key of the frozen head w_{1,hd}
    # numerics
    dtype: str = "bfloat16"          # compute/param dtype for the big runs
    # citation for the config values
    source: str = ""

    # ----- derived helpers -----
    def layer_kinds(self) -> tuple[str, ...]:
        """Expand block_pattern cyclically over num_layers."""
        pat = self.block_pattern
        return tuple(pat[i % len(pat)] for i in range(self.num_layers))

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 256 so TP=16 sharding divides evenly."""
        pad_to = 256
        return ((self.vocab_size + pad_to - 1) // pad_to) * pad_to

    def reduced(self, *, num_layers: int = 2, d_model: int = 256,
                num_heads: int = 4, d_ff: int = 512, vocab_size: int = 512,
                max_experts: int = 4) -> "ModelConfig":
        """A tiny same-family variant for CPU smoke tests."""
        head_dim = max(d_model // num_heads, 16)
        kv = max(1, min(self.num_kv_heads, num_heads))
        changes = dict(
            name=self.name + "-smoke",
            num_layers=num_layers,
            d_model=d_model,
            num_heads=num_heads,
            num_kv_heads=kv,
            head_dim=head_dim,
            d_ff=d_ff if self.d_ff else 0,
            vocab_size=vocab_size,
            sliding_window=min(self.sliding_window, 64) if self.sliding_window else 0,
            n_client_layers=1,
            dtype="float32",
        )
        if self.moe is not None:
            ne = min(self.moe.num_experts, max_experts)
            changes["moe"] = MoEConfig(
                num_experts=ne,
                top_k=min(self.moe.top_k, ne),
                d_ff_expert=128,
                num_shared_experts=min(self.moe.num_shared_experts, 1),
                d_ff_shared=128 if self.moe.num_shared_experts else 0,
                first_dense_layers=min(self.moe.first_dense_layers, 1),
                d_ff_dense=128 if self.moe.first_dense_layers else 0,
            )
        if self.mla is not None:
            changes["mla"] = MLAConfig(
                q_lora_rank=64, kv_lora_rank=32,
                qk_nope_head_dim=head_dim, qk_rope_head_dim=16,
                v_head_dim=head_dim)
        if self.encdec is not None:
            changes["encdec"] = EncDecConfig(num_encoder_layers=num_layers,
                                             max_source_len=32)
        if self.vlm is not None:
            half = head_dim // 2
            quarter = half // 4
            changes["vlm"] = VLMConfig(
                num_patch_tokens=16,
                mrope_sections=(half - 2 * quarter, quarter, quarter))
        if self.xlstm is not None:
            changes["xlstm"] = XLSTMConfig(num_heads=2)
        if self.rglru is not None:
            changes["rglru"] = RGLRUConfig(lru_width=d_model)
        return dataclasses.replace(self, **changes)


# --------------------------------------------------------------------------
# PHSFL hierarchy (Sec. II-B / III-A of the paper)
# --------------------------------------------------------------------------
@dataclass(frozen=True)
class HierarchyConfig:
    num_edge_servers: int = 4        # B
    clients_per_es: int = 25         # U_b (uniform here; weights may differ)
    kappa0: int = 5                  # local SGD steps per edge round
    kappa1: int = 3                  # edge rounds per global round
    global_rounds: int = 100         # R
    # aggregation weights: "uniform" or "data" (proportional to |D_u|)
    weighting: str = "data"

    @property
    def num_clients(self) -> int:
        return self.num_edge_servers * self.clients_per_es

    @property
    def steps_per_global_round(self) -> int:
        return self.kappa0 * self.kappa1


@dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 0.01      # eta (paper: SGD, eta=0.01)
    finetune_lr: float = 0.01        # eta~ for the head fine-tune (Eq. 18)
    finetune_steps: int = 10         # K
    batch_size: int = 32             # N
    optimizer: str = "sgd"           # sgd | momentum | adamw
    momentum: float = 0.0
    weight_decay: float = 0.0
    grad_clip: float = 0.0
    seed: int = 0
    freeze_head: bool = True         # PHSFL; False -> HSFL baseline
    # datacenter mode: microbatches per local round inside the fused step
    local_steps_in_step: int = 2
    remat: bool = True               # activation checkpointing per block
    remat_policy: str = "full"       # full | dots (selective, §Perf knob)
    shared_server: bool = False      # beyond-paper SFL-V2-style body sharing
    agg_dtype: str = "float32"       # aggregation psum dtype (perf knob)


# --------------------------------------------------------------------------
# Wireless network scenario (channel + participation; see repro_torch.wireless)
# --------------------------------------------------------------------------
@dataclass(frozen=True)
class FaultConfig:
    """Fault-injection knobs (``repro_torch.wireless.faults``).

    The DEFAULTS encode ZERO faults: ``erasure_prob=0``, ``crash_hazard=0``
    and an empty ``es_outage_trace`` leave the scheduler on its exact
    fault-free code path (the golden regressions pin this bit-for-bit);
    ``max_retries``/``backoff_s``/``failover`` are inert until one of the
    hazards is switched on.  See ``repro_torch/wireless/__init__.py`` for the
    full semantics of each knob.
    """
    erasure_prob: float = 0.0        # per-attempt payload erasure probability
    max_retries: int = 2             # HARQ retransmissions per payload (the
    #                                  payload is sent at most 1 + max_retries
    #                                  times); inert while erasure_prob == 0
    backoff_s: float = 0.0           # radio idle gap before each retransmit
    es_outage_trace: tuple[tuple[int, ...], ...] = ()  # round-major rows of
    #                                  per-ES down flags (cycled over rounds,
    #                                  resized over ESs); () -> no outages
    crash_hazard: float = 0.0        # per-round probability a scheduled
    #                                  client dies mid-round
    failover: str = "reassoc"        # outage policy: "reassoc" moves a dead
    #                                  ES's clients to the nearest live ES,
    #                                  "skip" sits them out for the round

    @property
    def active(self) -> bool:
        """True when any hazard is enabled (the scheduler builds a
        FaultInjector); False keeps the fault-free path untouched."""
        return (self.erasure_prob > 0.0 or self.crash_hazard > 0.0
                or len(self.es_outage_trace) > 0)


@dataclass(frozen=True)
class WirelessConfig:
    """Per-client channel + participation knobs for the wireless simulator.

    See ``repro_torch/wireless/__init__.py`` for the full knob documentation.
    """
    model: str = "ideal"             # ideal | static | rayleigh | trace
    mean_uplink_mbps: float = 10.0   # mean per-client uplink rate
    mean_downlink_mbps: float = 40.0  # mean per-client downlink rate
    latency_s: float = 0.02          # per-message propagation/queueing latency
    heterogeneity: float = 0.0       # lognormal sigma of a FIXED per-client
    #                                  rate scale (0 -> homogeneous clients)
    trace: tuple[tuple[float, ...], ...] = ()  # (round, client) uplink Mbps
    trace_down: tuple[tuple[float, ...], ...] = ()  # (round, client) downlink
    #                                  Mbps (same round-major/cycling rules as
    #                                  trace); () -> downlink is the uplink
    #                                  trace rescaled by the configured
    #                                  downlink/uplink mean ratio (fallback)
    # ---- per-ES shared uplink (contention) ----
    es_uplink_mbps: float = float("inf")  # shared ES uplink capacity, split
    #                                  among that round's scheduled clients
    #                                  (inf -> private uplinks)
    contention: str = "equal"        # sharing rule: "equal" splits the pipe
    #                                  evenly; "proportional" weights shares
    #                                  by each client's private rate
    reshare_uplink: bool = True      # after unaffordable clients withdraw,
    #                                  re-run contention so survivors absorb
    #                                  the freed capacity (False reproduces
    #                                  the conservative single pass)
    # ---- adaptive cut-layer selection (repro_torch.wireless.cutter) ----
    cut_policy: str = "fixed"        # fixed | greedy | deadline
    cut_candidates: tuple = ()       # candidate cuts, shallow -> deep: CNN
    #                                  cut names or LM client depths; () ->
    #                                  the model's single default cut
    # ---- pipelined streaming (repro_torch.wireless.timeline) ----
    pipeline: bool = False           # overlap client compute with uplink
    #                                  streaming at minibatch granularity:
    #                                  each minibatch's activations transmit
    #                                  as soon as its compute finishes, so
    #                                  round time ~ max(compute, tx) + one
    #                                  bubble instead of compute + tx.  False
    #                                  (default) is the serial Eq.-17 model,
    #                                  bit-for-bit
    # ---- staleness-weighted async edge aggregation ----
    staleness_lambda: float = 0.0    # lambda in [0, 1]: a deadline-cut
    #                                  straggler's partial update is BANKED
    #                                  and folded into the edge round where
    #                                  its remaining bits finally land, with
    #                                  weight alpha_u * lambda**staleness
    #                                  (staleness = edge rounds late).  0
    #                                  (default) reproduces today's hard
    #                                  dropout bit-for-bit
    # ---- participation policy (scheduler) ----
    deadline_s: float = float("inf")  # edge-round deadline; stragglers drop
    selection: str = "deadline"      # deadline | topk | random
    topk: int = 0                    # keep the k fastest (0 -> no cap)
    participation_prob: float = 1.0  # Bernoulli thinning (selection="random")
    # ---- energy ----
    energy_budget_j: float = float("inf")  # lifetime per-client budget
    tx_power_w: float = 0.5          # uplink transmit power
    # ---- device (compute) model (repro_torch.wireless.device) ----
    compute_gflops: float = float("inf")  # per-client compute rate (GFLOP/s);
    #                                  inf (default) = free compute, i.e. the
    #                                  bits-only simulator exactly
    compute_heterogeneity: float = 0.0  # lognormal sigma of a FIXED per-client
    #                                  compute scale (0 -> identical devices)
    compute_power_w: float = 0.0     # power drawn while computing (J/s);
    #                                  joins tx energy in the budget gate
    codec_cycles_per_element: float = 0.0  # FLOPs a client spends per element
    #                                  crossing a LOSSY codec (encode up,
    #                                  decode down); 0 = codecs compute-free
    # ---- fault injection + recovery (repro_torch.wireless.faults) ----
    faults: FaultConfig = FaultConfig()  # erasures/HARQ, ES outages, crashes;
    #                                  the all-defaults instance is the exact
    #                                  fault-free scheduler, bit-for-bit
    seed: int = 0


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode


@dataclass(frozen=True)
class MeshConfig:
    """The production mesh: 16 clients x 16-way tensor parallelism, or two
    pods (edge servers) of that."""
    multi_pod: bool = False

    @property
    def shape(self) -> tuple[int, ...]:
        return (2, 16, 16) if self.multi_pod else (16, 16)

    @property
    def axes(self) -> tuple[str, ...]:
        return ("pod", "data", "model") if self.multi_pod else ("data",
                                                                 "model")
