"""whisper-large-v3 [audio] — 32L d_model=1280 20H d_ff=5120 vocab=51866,
encoder-decoder; conv/mel frontend is a STUB per the assignment carve-out
(input_specs() provides precomputed frame embeddings). [arXiv:2212.04356]

32 encoder + 32 decoder layers (whisper-large layout). The decoder target
length is architecturally capped at 448 tokens; input shapes map seq_len to
ENCODER frames (downsampled 2x by the conv stub). The port's copy of
``repro.configs.whisper_large_v3``.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-large-v3",
    family="audio",
    n_layers=32,               # decoder layers
    encoder_layers=32,
    is_encoder_decoder=True,
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    d_ff=5120,
    vocab_size=51866,
    max_target_len=448,
    frontend_downsample=2,
    act="gelu",
    mlp_type="dense",
    norm="layernorm",
    tie_embeddings=True,
    source="arXiv:2212.04356",
    grad_accum={"train_4k": 2},
)


def smoke_config() -> ArchConfig:
    return CONFIG.replace(
        n_layers=2, encoder_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
        d_ff=256, vocab_size=512, max_target_len=32, remat=False,
        grad_accum={},
    )
