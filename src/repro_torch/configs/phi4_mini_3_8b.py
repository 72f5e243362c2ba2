"""phi4-mini-3.8b [dense]: 32L d_model=3072 24H (GQA kv=8) d_ff=8192
vocab=200064, RoPE SwiGLU GQA. [arXiv:2412.08905]. The port's copy of
``repro.configs.phi4_mini_3_8b``."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="phi4-mini-3.8b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=200064,
    act="silu",
    mlp_type="glu",
    source="arXiv:2412.08905",
    grad_accum={"train_4k": 2},
)


def smoke_config() -> ArchConfig:
    return CONFIG.replace(
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_ff=256,
        vocab_size=512, remat=False, grad_accum={},
    )
