"""qwen1.5-110b [dense]: 80L d_model=8192 64H (GQA kv=8) d_ff=49152
vocab=152064, QKV bias. [hf:Qwen/Qwen1.5-0.5B]. The port's copy of
``repro.configs.qwen1_5_110b``."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-110b",
    family="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=49152,
    vocab_size=152064,
    qkv_bias=True,
    act="silu",
    mlp_type="glu",
    tie_embeddings=False,
    source="hf:Qwen/Qwen1.5-0.5B",
    grad_accum={"train_4k": 8},
)


def smoke_config() -> ArchConfig:
    return CONFIG.replace(
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_ff=256,
        vocab_size=512, remat=False, grad_accum={},
    )
