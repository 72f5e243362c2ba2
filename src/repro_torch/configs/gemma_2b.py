"""gemma-2b [dense]: 18L d_model=2048 8H (MQA kv=1) d_ff=16384
vocab=256000, GeGLU, head_dim=256. [arXiv:2403.08295]. The port's copy
of ``repro.configs.gemma_2b``."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma-2b",
    family="dense",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=256000,
    act="gelu",            # GeGLU
    mlp_type="glu",
    source="arXiv:2403.08295",
    grad_accum={"train_4k": 4},
)


def smoke_config() -> ArchConfig:
    return CONFIG.replace(
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=1, head_dim=32,
        d_ff=256, vocab_size=512, remat=False, grad_accum={},
    )
