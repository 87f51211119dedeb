"""Configuration system for the repro framework.

Dataclass-based, hashable (frozen) configs so they can key jit caches.
Architecture configs live in ``repro_torch.configs.<arch>`` and register
themselves into a global registry via :func:`register_config`.
"""
from __future__ import annotations

import dataclasses
import importlib
import pkgutil
from dataclasses import dataclass, field
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Sub-configs for architecture families
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts FFN configuration."""

    num_experts: int
    top_k: int
    d_expert: int                 # hidden dim of each expert FFN
    num_shared_experts: int = 0   # DeepSeek-V2 style always-on experts
    d_shared: int = 0             # hidden dim of the shared expert(s)
    first_dense_layers: int = 0   # leading layers that use a dense FFN
    d_ff_dense: int = 0           # hidden dim of those dense FFNs
    router_aux_coef: float = 0.01  # load-balance auxiliary loss weight
    capacity_factor: float = 1.25  # expert capacity for dropless-ish dispatch
    expert_sharding: str = "expert"  # "expert" (expert-parallel) | "tp"


@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V2 Multi-head Latent Attention configuration."""

    kv_lora_rank: int = 512
    q_lora_rank: int = 0          # 0 => full-rank Q projection (V2-Lite)
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-1 selective SSM configuration."""

    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0              # 0 => ceil(d_model / 16)


@dataclass(frozen=True)
class RGLRUConfig:
    """RecurrentGemma RG-LRU recurrent block configuration."""

    lru_width: int = 0            # 0 => d_model
    conv1d_width: int = 4
    block_pattern: Tuple[str, ...] = ("rglru", "rglru", "attn")  # 2:1 recurrent:attn
    local_window: int = 2048


@dataclass(frozen=True)
class EncDecConfig:
    """Encoder-decoder (Whisper-style) configuration."""

    num_encoder_layers: int = 12
    encoder_seq_len: int = 1500   # post-conv frame count (stub frontend)


@dataclass(frozen=True)
class FrontendStub:
    """Modality frontend stub (vision patches / audio frames).

    Per the brief the ViT/conv encoder is NOT implemented; ``input_specs``
    provides precomputed embeddings of shape [batch, num_tokens, embed_dim].
    """

    kind: str                     # "vision" | "audio"
    embed_dim: int
    num_tokens: int


# ---------------------------------------------------------------------------
# Model config
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0             # 0 => d_model // num_heads
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    pos_embedding: str = "rope"   # rope | mrope | learned | none
    sliding_window: int = 0       # 0 => full attention
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    act: str = "silu"             # silu (SwiGLU) | gelu (plain MLP)
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    rglru: Optional[RGLRUConfig] = None
    encdec: Optional[EncDecConfig] = None
    frontend: Optional[FrontendStub] = None
    # classification head (the paper's ViT); 0 => LM head over vocab
    num_classes: int = 0
    # decode hot path: route GQA/MLA decode attention through the fused
    # Pallas kernel (kernels/decode_attn.py; interpret-mode off-TPU).
    # Model-level (not ControlContext) because the dense serve path runs
    # with ctx=None — set via ControlConfig.fused_attention, which the
    # step builders apply with dataclasses.replace.
    fused_decode_attn: bool = False
    source: str = ""              # citation

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.num_heads, 1)

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """True if sub-quadratic attention is native (SSM / hybrid / SWA)."""
        return (
            self.family in ("ssm", "hybrid")
            or self.sliding_window > 0
        )

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks), for reporting."""
        d, L, V = self.d_model, self.num_layers, self.vocab_size
        hd = self.resolved_head_dim
        emb = V * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        if self.family == "ssm":
            s = self.ssm or SSMConfig()
            d_in = s.expand * d
            dt_rank = s.dt_rank or -(-d // 16)
            per_layer = (
                d * 2 * d_in            # in_proj
                + d_in * s.d_conv       # conv
                + d_in * (dt_rank + 2 * s.d_state)  # x_proj
                + dt_rank * d_in        # dt_proj
                + d_in * s.d_state      # A
                + d_in * 2              # D, dt bias
                + d_in * d              # out_proj
            )
        else:
            if self.mla is not None:
                m = self.mla
                qdim = self.num_heads * (m.qk_nope_head_dim + m.qk_rope_head_dim)
                q = d * qdim if not m.q_lora_rank else d * m.q_lora_rank + m.q_lora_rank * qdim
                kv = d * (m.kv_lora_rank + m.qk_rope_head_dim) + m.kv_lora_rank * self.num_heads * (
                    m.qk_nope_head_dim + m.v_head_dim)
                o = self.num_heads * m.v_head_dim * d
                attn = q + kv + o
            else:
                attn = d * self.num_heads * hd + 2 * d * self.num_kv_heads * hd \
                    + self.num_heads * hd * d
            ff_mult = 3 if self.act == "silu" else 2
            if self.moe is not None:
                mo = self.moe
                moe_ff = mo.num_experts * ff_mult * d * mo.d_expert \
                    + mo.num_shared_experts * ff_mult * d * (mo.d_shared or mo.d_expert) \
                    + d * mo.num_experts
                n_moe = L - mo.first_dense_layers
                dense_ff = mo.first_dense_layers * ff_mult * d * (mo.d_ff_dense or self.d_ff)
                per_layer = attn + (moe_ff * n_moe + dense_ff) / L
            else:
                per_layer = attn + ff_mult * d * self.d_ff
        total = emb + int(L * per_layer)
        if self.encdec is not None:
            total += int(self.encdec.num_encoder_layers * per_layer)
        return total

    def active_param_count(self) -> int:
        """Parameters active per token (MoE top-k instead of all experts)."""
        if self.moe is None:
            return self.param_count()
        mo = self.moe
        d, L = self.d_model, self.num_layers
        ff_mult = 3 if self.act == "silu" else 2
        full = self.param_count()
        all_experts = (L - mo.first_dense_layers) * mo.num_experts * ff_mult * d * mo.d_expert
        active = (L - mo.first_dense_layers) * mo.top_k * ff_mult * d * mo.d_expert
        return full - all_experts + active


# ---------------------------------------------------------------------------
# Input shapes (assigned), mesh and run configs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                     # train | prefill | decode


INPUT_SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


@dataclass(frozen=True)
class MeshConfig:
    data: int = 16
    model: int = 16
    pod: int = 1

    @property
    def num_devices(self) -> int:
        return self.data * self.model * self.pod


@dataclass(frozen=True)
class WorkloadControlConfig:
    """The paper's technique knobs (Sec. III/IV)."""

    enabled: bool = False
    mode: str = "semi"            # zero | mig | semi | off
    # ZERO-resizing
    gamma_buckets: Tuple[float, ...] = (0.0, 0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875)
    block_size: int = 128         # pruning granularity (TPU-aligned), adapts down
    imputation: str = "zero"      # zero | average | same
    selection: str = "priority"   # random | priority | priority_diff
    alpha: float = 0.8            # decay factor for per-layer ratio floor (Sec. III-B)
    theta_iter: float = 1e-3      # micro-threshold for per-layer candidates
    # migration
    migration_block: int = 128    # migrated-column granularity
    max_migration_sources: int = 3   # concurrent straggler slots (0 = no mig)
    migration_shed_cap: int = 0      # per-source shed-block cap (0 = uncapped)
    # β source for SEMI's per-source mission split (Eq. 2): "eq2" balances
    # migration vs. resize cost (training default); "lossless" forces
    # β = 1 for every Eq.(3)-selected source — the whole offset volume
    # migrates, so the plan changes no outputs (the serve engine's
    # default: decode quality must not silently degrade under contention)
    beta_policy: str = "eq2"         # eq2 | lossless
    # controller
    tavg_refresh_threshold: float = 0.10   # passive T_avg refresh on >10% change
    # straggler-detection deadband: ranks within this relative margin of
    # T_ref are NOT stragglers. ±5% multiplicative measurement noise gives
    # a worst-case min-to-max spread of 1.05/0.95 ≈ 1.11, so 0.12 absorbs
    # it — plans stop flip-flopping on noise while real stragglers
    # (χ ≥ 2 in every paper scenario) sit far above the band.
    straggler_threshold: float = 0.12
    # execution: route controlled matmuls through the Pallas pruned-kernel
    # family (fused FFN + kernel-level backward; interpret-mode off-TPU)
    use_kernel: bool = False
    # decode raw-speed pass: fused decode-attention kernel and
    # chunked TP all-reduce epilogues. fused_attention flips
    # ModelConfig.fused_decode_attn in the step builders; psum_chunks > 1
    # splits the controlled-layer epilogue psum into that many
    # independent per-chunk all-reduces so the latency-hiding scheduler
    # can overlap them with the remaining compute.
    fused_attention: bool = False
    psum_chunks: int = 1
    # telemetry / closed-loop measured mode (DESIGN_TELEMETRY.md):
    # where the controller's per-rank times come from. "modeled" reads the
    # χ-oracle straight from the simulated schedule; "measured" consumes
    # StragglerEstimator reconstructions of measured (mitigated) times.
    times: str = "modeled"           # modeled | measured
    ewma_alpha: float = 0.4          # estimator EWMA weight (newest sample)
    estimator_warmup: int = 3        # samples before the warmup gate opens
    outlier_nmad: float = 4.0        # median/MAD spike-rejection threshold
    measure_interval: int = 1        # steps between in-graph rank gathers

    def __post_init__(self):
        # a typo'd beta_policy would silently fall through to the LOSSY
        # eq2 split — the exact silent quality degradation the lossless
        # policy exists to prevent — so reject unknown values loudly
        if self.beta_policy not in ("eq2", "lossless"):
            raise ValueError(
                f"beta_policy {self.beta_policy!r} is not one of "
                "('eq2', 'lossless')")
        if self.psum_chunks < 1:
            raise ValueError(
                f"psum_chunks must be >= 1, got {self.psum_chunks}")


@dataclass(frozen=True)
class TrainConfig:
    steps: int = 100
    learning_rate: float = 3e-3
    weight_decay: float = 0.0
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    grad_clip: float = 1.0
    warmup_steps: int = 10
    seed: int = 0
    microbatch: int = 0           # 0 => no gradient accumulation
    remat: str = "none"           # none | block | full
    fsdp_layers: bool = False     # shard the stacked-layer dim over data
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"


@dataclass(frozen=True)
class RunConfig:
    model: ModelConfig
    shape: ShapeConfig
    mesh: MeshConfig = MeshConfig()
    train: TrainConfig = TrainConfig()
    control: WorkloadControlConfig = WorkloadControlConfig()


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: dict = {}


def register_config(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def _load_all() -> None:
    from repro_torch import configs as cfg_pkg

    for mod in pkgutil.iter_modules(cfg_pkg.__path__):
        if not mod.name.startswith("_"):
            importlib.import_module(f"repro_torch.configs.{mod.name}")


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        _load_all()
    if name not in _REGISTRY:
        raise KeyError(f"unknown architecture {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_configs() -> list:
    _load_all()
    return sorted(_REGISTRY)


def smoke_variant(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family variant: 2 layers, d_model<=512, <=4 experts."""
    d = min(cfg.d_model, 256)
    heads = min(cfg.num_heads, 4) or 1
    kv = max(1, min(cfg.num_kv_heads, heads))
    # keep the GQA ratio flavor: if original had kv < heads, keep kv < heads
    if cfg.num_kv_heads < cfg.num_heads and kv == heads:
        kv = max(1, heads // 2)
    updates = dict(
        name=cfg.name + "-smoke",
        num_layers=2,
        d_model=d,
        num_heads=heads,
        num_kv_heads=kv,
        head_dim=d // heads if cfg.family != "moe" or True else 0,
        d_ff=min(cfg.d_ff, 512) if cfg.d_ff else 0,
        vocab_size=min(cfg.vocab_size, 512),
    )
    if cfg.moe is not None:
        updates["moe"] = dataclasses.replace(
            cfg.moe,
            num_experts=min(cfg.moe.num_experts, 4),
            top_k=min(cfg.moe.top_k, 2),
            d_expert=min(cfg.moe.d_expert, 256),
            num_shared_experts=min(cfg.moe.num_shared_experts, 1),
            d_shared=min(cfg.moe.d_shared, 256) if cfg.moe.d_shared else 0,
            first_dense_layers=min(cfg.moe.first_dense_layers, 1),
            d_ff_dense=min(cfg.moe.d_ff_dense, 256) if cfg.moe.d_ff_dense else 0,
        )
    if cfg.mla is not None:
        updates["mla"] = MLAConfig(
            kv_lora_rank=64, q_lora_rank=0, qk_nope_head_dim=32,
            qk_rope_head_dim=16, v_head_dim=32)
        updates["head_dim"] = 0
    if cfg.ssm is not None:
        updates["ssm"] = dataclasses.replace(cfg.ssm, d_state=8)
    if cfg.rglru is not None:
        updates["rglru"] = dataclasses.replace(
            cfg.rglru, lru_width=0, local_window=64)
    if cfg.encdec is not None:
        updates["encdec"] = EncDecConfig(num_encoder_layers=2, encoder_seq_len=32)
    if cfg.frontend is not None:
        # classifiers keep their token count (image geometry fixes it)
        ntok = cfg.frontend.num_tokens if cfg.num_classes else 16
        updates["frontend"] = FrontendStub(
            kind=cfg.frontend.kind, embed_dim=d, num_tokens=ntok)
    if cfg.sliding_window:
        updates["sliding_window"] = 32
    return dataclasses.replace(cfg, **updates)
