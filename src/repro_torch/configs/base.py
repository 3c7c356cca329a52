"""Configurations: the model zoo's :class:`ModelConfig` and the
federated-learning experiment's :class:`FLConfig` (paper §2, §4).

``ModelConfig`` is a copy of the reference's: every field with the same
default, ``round_up``, the properties ``hd``, ``padded_vocab``,
``d_inner``, ``ssm_heads``, ``is_encoder_decoder`` and
``supports_long_decode``, and the checks of ``validate()`` (raised as
``ValueError``).  The fields that only pick an implementation in the
reference (``remat``, ``scan_layers``, ``attn_impl``,
``moe_dispatch_impl``, ``sharding``) and the training policy
(``optimizer``) are accepted; the serving path computes the same
function under each.

``InputShape`` and ``INPUT_SHAPES`` are the reference's four input
shapes of the zoo (the dry run's, :mod:`repro_torch.launch.dryrun`).

``FLConfig`` is a copy of the reference's and its ``validate()``: the
same fields, defaults and checks, so a config written for the reference
means the same experiment here.  ``batch_clients=True`` (the default, as
in the reference) runs the horizon-batched engine, ``False`` the
sequential per-upload engine, its parity oracle;
:class:`repro_torch.core.safl.FLEngine` refuses every setting it does not
run (see ``FLEngine.PORTED``) instead of ignoring it.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

#: the reference's model families
FAMILIES = ("dense", "moe", "ssm", "hybrid", "audio", "vlm")


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


#: the zoo's four input shapes (the reference's ``INPUT_SHAPES``)
INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture description (the reference's fields and defaults).

    ``family`` selects the block stack:
      dense   — pre-norm decoder (GQA attention + gated MLP)
      moe     — dense attention + mixture-of-experts MLP
      ssm     — xLSTM (alternating mLSTM / sLSTM blocks)
      hybrid  — Mamba2 backbone with a shared attention block every Nth layer
      audio   — encoder-decoder; the encoder takes frame embeddings
      vlm     — decoder LM after a patch-embedding prefix
    """

    name: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads

    # --- attention ---
    rope_theta: float = 10_000.0
    qk_norm: bool = False
    sliding_window: Optional[int] = None  # native window (starcoder2)
    long_context_window: int = 8_192  # window used for long_500k decode
    attn_chunk: int = 0  # 0 -> full-matrix attention; >0 -> q-chunked
    attn_impl: str = "chunked"  # chunked | online
    attn_kv_chunk: int = 1_024  # kv tile for attn_impl="online"

    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    moe_group_size: int = 1_024
    first_k_dense: int = 0  # leading dense layers before the MoE stack
    moe_dispatch_dtype: str = "float32"
    moe_dispatch_impl: str = "einsum"  # einsum | scatter

    # --- SSM / hybrid (Mamba2) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_chunk: int = 256
    hybrid_attn_every: int = 0  # zamba2: shared attn block every Nth layer

    # --- xLSTM ---
    block_pattern: Tuple[str, ...] = ()  # e.g. ("mlstm", "slstm")

    # --- encoder-decoder ---
    enc_layers: int = 0

    # --- modality frontend stub ---
    n_prefix_tokens: int = 0  # VLM patches

    # --- numerics ---
    act: str = "swiglu"  # swiglu | gelu
    norm_eps: float = 1e-5
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    tie_embeddings: bool = False
    vocab_pad_to: int = 2_048

    # --- distribution / training policy ---
    sharding: str = "megatron"  # megatron | fsdp
    optimizer: str = "sgdm"  # sgd | sgdm | adamw
    remat: bool = True
    scan_layers: bool = True
    source: str = ""  # citation for the assignment row

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def padded_vocab(self) -> int:
        return round_up(self.vocab_size, self.vocab_pad_to)

    @property
    def d_inner(self) -> int:  # mamba2 inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def is_encoder_decoder(self) -> bool:
        return self.family == "audio"

    @property
    def supports_long_decode(self) -> bool:
        """The enc-dec speech model has no long autoregressive mode."""
        return self.family != "audio"

    def validate(self) -> None:
        if self.family not in FAMILIES:
            raise ValueError(f"family {self.family!r} not in {FAMILIES}")
        if self.family != "ssm":
            if self.d_model % self.n_heads and not self.head_dim:
                raise ValueError(
                    f"d_model {self.d_model} is not a multiple of n_heads "
                    f"{self.n_heads} and head_dim is 0")
            if self.n_heads % self.n_kv_heads:
                raise ValueError(f"n_heads {self.n_heads} is not a multiple "
                                 f"of n_kv_heads {self.n_kv_heads}")
        if self.family == "moe" and not (self.n_experts > 0
                                         and self.top_k > 0):
            raise ValueError("the moe family needs n_experts > 0 and "
                             "top_k > 0")
        if self.family == "ssm" and not self.block_pattern:
            raise ValueError("the ssm family needs a block pattern")
        if self.family == "hybrid" and not (
                self.hybrid_attn_every > 0
                and self.n_layers % self.hybrid_attn_every == 0):
            raise ValueError(
                f"the hybrid family needs hybrid_attn_every > 0 dividing "
                f"n_layers {self.n_layers}, got {self.hybrid_attn_every}")


@dataclasses.dataclass(frozen=True)
class FLConfig:
    """One SAFL/SFL experiment.  Field meanings follow the reference
    ``FLConfig``; the knobs this package runs: ``mode`` sync/semi_async,
    every ``aggregation`` of the study (fedsgd, fedavg, fedbuff,
    fedasync, fedopt, sdga), the f32, q8 and q4 wires
    (``compress_updates`` is the q8 alias), either ``server_channel``,
    the ``k`` horizon, static timing, full participation, one device,
    faults with the screen / clip defense (semi-async), tracing off."""

    n_clients: int = 50
    k: int = 10  # aggregation buffer size / activation count
    horizon: str = "k"  # "k" | "queue" | "timeout" | "hybrid"
    horizon_queue: int = 0  # queue/hybrid: uploads per horizon (0 -> k)
    horizon_timeout_s: float = 0.0  # timeout/hybrid: horizon wall-clock
    # "auto" (streaming for semi_async, buffered for sync), "streaming"
    # (O(D) accumulate-on-arrival), "buffered" (resident (K, D) rows)
    server_channel: str = "auto"
    mode: str = "semi_async"  # "sync" | "semi_async"
    aggregation: str = "fedsgd"  # fedsgd | fedavg | sdga | fedasync | fedbuff | fedopt
    local_epochs: int = 1
    local_batch_size: int = 32
    client_lr: float = 0.05
    server_lr: float = 1.0  # eta in Eq. (5)
    staleness_alpha: float = 0.5  # polynomial discount (1+tau)^-alpha
    server_momentum: float = 0.0
    ema_anchor: float = 0.0
    fedasync_alpha: float = 0.6
    speed_sigma: float = 0.6
    comm_mean_s: float = 1.0
    seed: int = 0
    sched_timing: str = "static"  # static | lognormal | markov
    sched_jitter_sigma: float = 0.25
    sched_drop_p: float = 0.1
    sched_off_mean_s: float = 5.0
    sched_policy: str = "full"  # full | uniform | seafl | fedqs | ratelimit
    sched_c: int = 0
    sched_stale_cap: int = 4
    sched_qs_beta: float = 1.0
    sched_rate_limit: int = 0
    sched_seed: int = 0
    wire: str = "f32"  # f32 | q8 | q4 | topk
    topk_frac: float = 0.1
    compress_updates: bool = False  # legacy alias for wire="q8"
    quant_block: int = 512
    error_feedback: bool = True
    # horizon-batched engine: a horizon's K local trainings run as waves
    # of K lanes (FLEngine._run_semi_async_batched, the batched sync
    # round); False forces the sequential per-upload engine, the parity
    # oracle
    batch_clients: bool = True
    devices: int = 1
    mesh_shape: Optional[Tuple[int, int]] = None
    wave_impl: str = "auto"
    # the reference pads a wave to a power of two so XLA compiles few
    # shapes; PyTorch compiles nothing per shape, so the port accepts the
    # field and runs every wave at its own size either way
    wave_buckets: bool = True
    eval_every: int = 1
    fault_crash_p: float = 0.0
    fault_straggler_p: float = 0.0
    fault_straggler_mult: float = 8.0
    fault_corrupt_p: float = 0.0
    fault_byzantine_p: float = 0.0
    fault_byzantine_rescale: float = 10.0
    fault_seed: int = 7
    fault_retry_backoff_s: float = 1.0
    fault_retry_cap: int = 5
    defense: str = "none"  # none | screen | clip
    defense_norm_cap: float = 0.0
    trace_level: str = "off"  # off | round | upload
    trace_dir: str = ""
    target_accuracy: float = 0.5  # Acc_t for T_f / T_s
    oscillation_thresholds: Tuple[float, ...] = (0.02, 0.05, 0.10, 0.15)

    @property
    def mesh_devices(self) -> int:
        """Total mesh shard count: E*P under ``mesh_shape``, else the 1-D
        ``devices`` count."""
        if self.mesh_shape is not None:
            return self.mesh_shape[0] * self.mesh_shape[1]
        return self.devices

    def validate(self) -> None:
        assert self.mode in ("sync", "semi_async")
        assert 1 <= self.k <= self.n_clients
        assert self.aggregation in (
            "fedsgd", "fedavg", "sdga", "fedasync", "fedbuff", "fedopt")
        assert self.local_epochs >= 1, "local_epochs must be >= 1"
        assert self.local_batch_size >= 1
        assert (8 <= self.quant_block <= 2048
                and self.quant_block & (self.quant_block - 1) == 0), \
            "quant_block must be a power of two in [8, 2048]"
        assert self.wire in ("f32", "q8", "q4", "topk"), self.wire
        if self.compress_updates:
            assert self.wire in ("f32", "q8"), \
                (f"compress_updates=True is the legacy alias for "
                 f"wire='q8' — it conflicts with wire='{self.wire}'")
        assert 0.0 < self.topk_frac <= 1.0, \
            f"topk_frac={self.topk_frac} must be in (0, 1]"
        if self.wire == "topk":
            assert self.aggregation not in ("fedavg", "fedasync"), \
                ("wire='topk' is gradient-only: fedavg/fedasync upload "
                 "weights, and a sparse weight average would zero every "
                 "untransmitted coordinate")
        assert self.eval_every >= 1, "eval_every must be >= 1"
        assert self.sched_timing in ("static", "lognormal", "markov"), \
            self.sched_timing
        assert self.sched_policy in (
            "full", "uniform", "seafl", "fedqs", "ratelimit"), \
            self.sched_policy
        assert self.sched_rate_limit >= 0, "sched_rate_limit must be >= 0"
        assert self.trace_level in ("off", "round", "upload"), \
            self.trace_level
        if self.sched_policy == "ratelimit" and self.horizon in ("k",
                                                                 "queue"):
            target = (self.k if self.horizon == "k"
                      else (self.horizon_queue or self.k))
            limit = self.sched_rate_limit or self.k
            assert limit >= target, \
                (f"sched_rate_limit={limit} cannot fill a "
                 f"{self.horizon} horizon of {target} uploads")
        assert self.horizon in ("k", "queue", "timeout", "hybrid"), \
            self.horizon
        assert self.horizon_queue >= 0, "horizon_queue must be >= 0 (0 -> k)"
        if self.horizon in ("timeout", "hybrid"):
            assert self.horizon_timeout_s > 0.0, \
                f"horizon={self.horizon} needs horizon_timeout_s > 0"
            assert self.mode == "semi_async", \
                "timeout/hybrid horizons are semi-async constructs"
        assert self.server_channel in ("auto", "streaming", "buffered"), \
            self.server_channel
        if self.server_channel == "buffered":
            assert self.horizon in ("k", "queue"), \
                "buffered channel needs a fixed horizon (k or queue)"
        if self.server_channel == "streaming":
            assert self.mode == "semi_async", \
                "streaming accumulation is a semi-async construct (the " \
                "sync round produces its (K, D) rows as one program)"
        assert self.sched_jitter_sigma >= 0.0
        assert 0.0 <= self.sched_drop_p < 1.0, \
            "sched_drop_p must be in [0, 1) (1 would end every schedule)"
        assert self.sched_off_mean_s > 0.0
        assert self.sched_stale_cap >= 0
        assert 0 <= self.sched_c <= self.n_clients, \
            f"sched_c={self.sched_c} must be in [0, n_clients]"
        assert isinstance(self.batch_clients, bool)
        assert self.wave_impl in ("vmap", "map", "auto"), self.wave_impl
        assert isinstance(self.wave_buckets, bool)
        for p in (self.fault_crash_p, self.fault_straggler_p,
                  self.fault_corrupt_p, self.fault_byzantine_p):
            assert 0.0 <= p <= 1.0, f"fault probability {p} not in [0, 1]"
        if (self.fault_crash_p or self.fault_straggler_p
                or self.fault_corrupt_p or self.fault_byzantine_p):
            assert self.mode == "semi_async", \
                ("fault injection rides the semi-async event heap; the "
                 "sync round has no per-upload schedule to perturb")
        assert self.fault_straggler_mult >= 1.0, \
            "fault_straggler_mult must be >= 1 (a spike, not a speedup)"
        assert self.fault_byzantine_rescale > 0.0
        assert self.fault_retry_backoff_s > 0.0
        assert self.fault_retry_cap >= 1, \
            "fault_retry_cap must be >= 1 (caps the backoff exponent)"
        assert self.defense in ("none", "screen", "clip"), self.defense
        if self.defense != "none":
            assert self.mode == "semi_async", \
                "defense screening guards the semi-async upload channel"
        if self.defense == "clip":
            assert self.defense_norm_cap > 0.0, \
                "defense='clip' needs defense_norm_cap > 0 (the norm cap)"
        assert self.defense_norm_cap >= 0.0
        assert self.devices >= 1, "devices must be >= 1"
        if self.mesh_shape is not None:
            assert (isinstance(self.mesh_shape, tuple)
                    and len(self.mesh_shape) == 2), \
                f"mesh_shape={self.mesh_shape!r} must be an (edges, pods) " \
                "pair"
            e, p = self.mesh_shape
            assert e >= 1 and p >= 1, self.mesh_shape
            assert p & (p - 1) == 0, \
                (f"mesh_shape pods={p} must be a power of two (the "
                 "intra-edge tree reduce pairs shards by XOR rounds)")
            assert self.devices == 1 or self.devices == e * p, \
                (f"devices={self.devices} conflicts with mesh_shape="
                 f"{self.mesh_shape} ({e * p} devices); set one knob, or "
                 "make them agree")
        n_sh = self.mesh_devices
        if n_sh > 1:
            assert self.k % n_sh == 0, \
                (f"k={self.k} must be a multiple of the mesh device count "
                 f"{n_sh} (devices/mesh_shape: the channel rows shard "
                 "evenly over the row axes)")
            if self.horizon == "queue":
                q = self.horizon_queue or self.k
                assert q % n_sh == 0, \
                    (f"queue horizon of {q} uploads must be a multiple of "
                     f"the mesh device count {n_sh} (the channel rows "
                     "shard evenly over the row axes)")
