"""internlm2-1.8b [dense]: 24L d_model=2048 16H (GQA kv=8) d_ff=8192
vocab=92544. [arXiv:2403.17297]. The port's copy of
``repro.configs.internlm2_1_8b``."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internlm2-1.8b",
    family="dense",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=92544,
    act="silu",
    mlp_type="glu",
    source="arXiv:2403.17297",
    grad_accum={"train_4k": 4},
    remat_policy="save_dots",
)


def smoke_config() -> ArchConfig:
    return CONFIG.replace(
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_ff=256,
        vocab_size=512, remat=False, grad_accum={},
    )
