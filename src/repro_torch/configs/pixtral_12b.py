"""pixtral-12b [vlm] — 40L d_model=5120 32H (GQA kv=8) d_ff=14336
vocab=131072, head_dim=128 (mistral-nemo backbone); pixtral-ViT vision
encoder + projector are a STUB per the assignment carve-out
(input_specs() provides patch embeddings). [hf:mistralai/Pixtral-12B-2409]
The port's copy of ``repro.configs.pixtral_12b``."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="pixtral-12b",
    family="vlm",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=131072,
    act="silu",
    mlp_type="glu",
    source="hf:mistralai/Pixtral-12B-2409",
    grad_accum={"train_4k": 8},
)


def smoke_config() -> ArchConfig:
    return CONFIG.replace(
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
        d_ff=256, vocab_size=512, remat=False, grad_accum={},
    )
