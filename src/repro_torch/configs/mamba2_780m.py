"""mamba2-780m [ssm] — 48L d_model=1536 attention-free, vocab=50280,
ssm_state=128, SSD (state-space duality). [arXiv:2405.21060]. The port's
copy of ``repro.configs.mamba2_780m``."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-780m",
    family="ssm",
    n_layers=48,
    d_model=1536,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_headdim=64,
    ssm_expand=2,
    ssm_conv=4,
    ssm_chunk=128,
    source="arXiv:2405.21060",
)


def smoke_config() -> ArchConfig:
    return CONFIG.replace(
        n_layers=2, d_model=128, ssm_state=16, ssm_headdim=32,
        ssm_chunk=32, vocab_size=512, remat=False,
    )
