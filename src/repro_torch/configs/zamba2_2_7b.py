"""zamba2-2.7b [hybrid] — 54L d_model=2560 32H d_ff=10240 vocab=32000,
ssm_state=64; Mamba2 backbone with a SHARED attention block applied every
6 layers (zamba2 weight sharing). [arXiv:2411.15242]. The port's copy of
``repro.configs.zamba2_2_7b``."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10240,
    vocab_size=32000,
    ssm_state=64,
    ssm_headdim=64,
    ssm_expand=2,
    ssm_conv=4,
    ssm_chunk=256,
    attn_every=6,
    sliding_window=8192,      # the shared attention block's window
    act="silu",
    mlp_type="glu",
    source="arXiv:2411.15242",
    grad_accum={"train_4k": 2},
)


def smoke_config() -> ArchConfig:
    return CONFIG.replace(
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, d_ff=256,
        ssm_state=16, ssm_headdim=32, ssm_chunk=32, attn_every=2,
        sliding_window=0, vocab_size=512, remat=False, grad_accum={},
    )
