"""deepseek-v2-236b [moe]: 60L d_model=5120 128H d_ff(expert)=1536
vocab=102400, MLA kv_lora=512, 2 shared + 160 routed experts top-6.
[arXiv:2405.04434]. The port's copy of ``repro.configs.deepseek_v2_236b``,
with its simplification: one latent KV down-projection (rank 512),
per-head up-projections, and a 64-wide RoPE key shared by the heads
(``models/mla.py``)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-v2-236b",
    family="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,          # MLA: latent cache; kv heads logical only
    head_dim=128,
    d_ff=12288,              # dense-equivalent (unused for routed layers)
    vocab_size=102400,
    n_experts=160,
    n_shared_experts=2,
    experts_per_token=6,
    moe_d_ff=1536,
    use_mla=True,
    kv_lora_rank=512,
    act="silu",
    mlp_type="glu",
    source="arXiv:2405.04434",
    grad_accum={"train_4k": 8},
)


def smoke_config() -> ArchConfig:
    return CONFIG.replace(
        n_layers=2, d_model=256, n_heads=4, n_kv_heads=4, head_dim=64,
        d_ff=256, moe_d_ff=128, n_experts=4, n_shared_experts=1,
        experts_per_token=2, kv_lora_rank=64, vocab_size=512,
        remat=False, grad_accum={},
    )
