"""qwen2-1.5b [dense] — GQA with QKV bias, tied embeddings.

28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936
[arXiv:2407.10671; hf]
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-1.5b",
    family="lm",
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    d_ff=8960,
    vocab=151936,
    pattern=("attn",),
    n_groups=28,
    qkv_bias=True,
    tie_embeddings=True,
    attention="taylor",
    pos="rope",
    rope_theta=1000000.0,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=128,
        n_groups=3, dtype="float32", remat="none", attn_chunk=16, max_seq=256,
    )
