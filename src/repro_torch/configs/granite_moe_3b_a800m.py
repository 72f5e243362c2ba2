"""granite-moe-3b-a800m [moe]: 32L d_model=1536 24H (GQA kv=8) d_ff=512,
vocab=49155, MoE 40 experts top-8. [hf:ibm-granite/granite-3.0-1b-a400m-base].
The port's copy of ``repro.configs.granite_moe_3b_a800m`` (40 experts,
the assignment's structured field, as the reference follows)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    d_ff=512,
    vocab_size=49155,
    n_experts=40,
    experts_per_token=8,
    moe_d_ff=512,
    act="silu",
    mlp_type="glu",
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
    grad_accum={"train_4k": 4},
)


def smoke_config() -> ArchConfig:
    return CONFIG.replace(
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_ff=64,
        moe_d_ff=64, n_experts=4, experts_per_token=2, vocab_size=512,
        remat=False, grad_accum={},
    )
