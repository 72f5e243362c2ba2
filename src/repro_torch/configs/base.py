"""Configuration dataclasses: the port's copy of ``repro.configs.base``.

``ArchConfig`` describes one architecture of the LM zoo (same fields,
defaults and properties, ``param_count`` included), ``InputShape`` one
workload shape, and ``RAgeKConfig`` the rAge-k protocol's run settings
with the same construction-time validation. Pinned equal to the
originals by ``tests/test_torch_host_copies.py``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field


def pad_to_multiple(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class ArchConfig:
    """A single architecture. Only the transformer backbone for audio/vlm."""

    name: str
    family: str                      # dense | moe | ssm | hybrid | audio | vlm | mlp | cnn
    n_layers: int
    d_model: int
    n_heads: int = 0                 # 0 => attention-free
    n_kv_heads: int = 0
    head_dim: int = 0                # 0 => d_model // n_heads
    d_ff: int = 0
    vocab_size: int = 0
    source: str = ""                 # citation from the assignment pool

    # --- MLP / activation ---
    act: str = "silu"                # silu | gelu
    mlp_type: str = "glu"            # glu (SwiGLU/GeGLU) | dense (2-matrix MLP)
    qkv_bias: bool = False

    # --- MoE ---
    n_experts: int = 0
    n_shared_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0                # per-expert hidden (defaults to d_ff)
    capacity_factor: float = 1.25

    # --- MLA (DeepSeek) ---
    use_mla: bool = False
    kv_lora_rank: int = 0

    # --- SSM (Mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 256             # SSD chunk length

    # --- hybrid (Zamba2) ---
    attn_every: int = 0              # shared attention block period (0 = none)

    # --- attention variants ---
    sliding_window: int = 0          # 0 = full attention
    # sequence-parallel attention for heads % model_axis != 0 archs:
    # removes fp32 score psums, halves mem/dev, but grows total collective
    # bytes (kv gathers in bwd) — net loss on the dominant term at train_4k,
    # kept opt-in (§Perf granite iteration 5, refuted)
    seq_parallel_attn: bool = False

    # --- encoder-decoder (Whisper) ---
    is_encoder_decoder: bool = False
    encoder_layers: int = 0
    max_target_len: int = 448
    frontend_downsample: int = 1     # conv stub downsampling of input frames

    # --- misc ---
    rope_theta: float = 10000.0
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    norm_eps: float = 1e-5
    tie_embeddings: bool = True
    dtype: str = "bfloat16"
    remat: bool = True
    remat_policy: str = "full"       # full | save_dots (§Perf internlm iter)
    # gradient accumulation microbatches for train_step (per input shape name)
    grad_accum: dict = field(default_factory=dict)

    # ------------------------------------------------------------------
    @property
    def head_dim_(self) -> int:
        if self.head_dim:
            return self.head_dim
        if self.n_heads:
            return self.d_model // self.n_heads
        return 0

    @property
    def padded_vocab(self) -> int:
        return pad_to_multiple(self.vocab_size, 512)

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def d_inner(self) -> int:
        """Mamba2 inner width."""
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.d_inner // self.ssm_headdim

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def moe_hidden(self) -> int:
        return self.moe_d_ff or self.d_ff

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    # --- parameter counting (analytic; used for roofline MODEL_FLOPS) ---
    def param_count(self, active_only: bool = False) -> int:
        """Analytic parameter count of the backbone (embeddings included)."""
        d, v = self.d_model, self.padded_vocab
        n = v * d  # embedding
        if not self.tie_embeddings:
            n += v * d
        hd = self.head_dim_

        def attn_params() -> int:
            if self.use_mla:
                # q proj + kv down + kv up (k_nope + v) + o proj
                p = d * self.n_heads * hd          # W_q
                p += d * self.kv_lora_rank          # W_dkv
                p += self.kv_lora_rank * self.n_heads * hd * 2  # W_uk, W_uv
                p += self.n_heads * hd * d          # W_o
                return p
            qkv = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd
            if self.qkv_bias:
                qkv += (self.n_heads + 2 * self.n_kv_heads) * hd
            return qkv + self.n_heads * hd * d

        def mlp_params(hidden: int) -> int:
            if self.mlp_type == "glu":
                return 3 * d * hidden
            return 2 * d * hidden

        def ssm_params() -> int:
            di, ns, nh = self.d_inner, self.ssm_state, self.ssm_nheads
            p = d * (2 * di + 2 * ns + nh)     # in_proj -> [x, z, B, C, dt]
            p += self.ssm_conv * (di + 2 * ns)  # depthwise conv over x,B,C
            p += nh * 2                          # A_log, D
            p += di * d                          # out_proj
            return p

        per_layer = 0
        if self.family == "ssm":
            per_layer = ssm_params() + d  # + norm
            n += self.n_layers * per_layer
        elif self.family == "hybrid":
            n_attn = self.n_layers // self.attn_every if self.attn_every else 0
            n += self.n_layers * (ssm_params() + d)
            # one SHARED attention+mlp block (zamba2 weight sharing)
            n += attn_params() + mlp_params(self.d_ff) + 2 * d
            del n_attn
        elif self.is_moe:
            shared = self.n_shared_experts * mlp_params(self.moe_hidden)
            experts = self.n_experts * mlp_params(self.moe_hidden)
            router = d * self.n_experts
            n += self.n_layers * (attn_params() + shared + experts + router + 2 * d)
        elif self.is_encoder_decoder:
            enc = self.encoder_layers * (attn_params() + mlp_params(self.d_ff) + 2 * d)
            dec = self.n_layers * (2 * attn_params() + mlp_params(self.d_ff) + 3 * d)
            n += enc + dec
        else:
            n += self.n_layers * (attn_params() + mlp_params(self.d_ff) + 2 * d)

        if active_only and self.is_moe:
            act_experts = (self.experts_per_token + self.n_shared_experts)
            dense_part = n - self.n_layers * self.n_experts * mlp_params(self.moe_hidden)
            return dense_part + self.n_layers * act_experts * mlp_params(self.moe_hidden)
        return n


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode


TRAIN_4K = InputShape("train_4k", 4_096, 256, "train")
PREFILL_32K = InputShape("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = InputShape("decode_32k", 32_768, 128, "decode")
LONG_500K = InputShape("long_500k", 524_288, 1, "decode")

INPUT_SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}


@dataclass(frozen=True)
class RAgeKConfig:
    """Hyper-parameters of the paper's protocol (Alg. 1/2 + §III-B)."""

    r: int = 75                      # magnitude pre-selection size
    k: int = 10                      # requested indices per round
    H: int = 4                       # local steps per global round
    M: int = 20                      # clustering cadence (global rounds)
    eps: float = 0.3                 # DBSCAN eps on 1 - similarity
    min_pts: int = 2                 # DBSCAN minPts
    lr: float = 1e-4                 # Adam lr (paper)
    batch_size: int = 256
    method: str = "rage_k"           # rage_k | rtop_k | top_k | random_k | dense | cafe
    disjoint_in_cluster: bool = True # PS requests disjoint sets within a cluster
    wire_dtype: str = "float32"      # paper: fp32 values; bf16 = beyond-paper
    cafe_lam: float = 0.1            # CAFe cost weight (method == "cafe")
    candidates: str = "threshold"    # top-r report: 'threshold' | 'sort'
    schedule: str = "full"           # participation plane
    participation_m: int = 0         # 0 -> max(N // 4, 1) (uniform/aoi)
    deadline_s: float = 0.0          # 0 -> 1.0 simulated s (deadline)
    buffer_k: int = 0                # async service: 0 -> N
    staleness_eta: float = 0.5
    version_window: int = 1
    age_layout: str = "dense"        # 'dense' | 'hierarchical'

    _METHODS = ("rage_k", "rtop_k", "top_k", "random_k", "dense", "cafe")
    _CANDIDATES = ("sort", "threshold")
    _SCHEDULES = ("full", "uniform", "aoi", "deadline")
    _WIRE_DTYPES = ("float32", "bfloat16", "float16")
    _AGE_LAYOUTS = ("dense", "hierarchical")

    def __post_init__(self):
        for name, allowed in (("method", self._METHODS),
                              ("candidates", self._CANDIDATES),
                              ("schedule", self._SCHEDULES),
                              ("wire_dtype", self._WIRE_DTYPES),
                              ("age_layout", self._AGE_LAYOUTS)):
            if getattr(self, name) not in allowed:
                raise ValueError(f"{name} must be one of {allowed}, "
                                 f"got {getattr(self, name)!r}")
        for name in ("r", "k", "H", "M", "batch_size", "min_pts"):
            if getattr(self, name) < 1:
                raise ValueError(f"{name} must be >= 1, "
                                 f"got {getattr(self, name)}")
        if self.method in ("rage_k", "rtop_k", "cafe") and self.r < self.k:
            raise ValueError(
                f"method {self.method!r} selects k of the top-r "
                f"candidates; need r >= k (got r={self.r}, k={self.k})")
        for name in ("lr", "eps"):
            if getattr(self, name) <= 0:
                raise ValueError(f"{name} must be > 0, "
                                 f"got {getattr(self, name)}")
        for name in ("participation_m", "deadline_s", "buffer_k",
                     "staleness_eta"):
            if getattr(self, name) < 0:
                raise ValueError(f"{name} must be >= 0, "
                                 f"got {getattr(self, name)}")
        if self.version_window < 1:
            raise ValueError(f"version_window must be >= 1, "
                             f"got {self.version_window}")
