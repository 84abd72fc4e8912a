"""gemma-7b [dense] — GeGLU, head_dim=256, sqrt(d) embedding scale.

28L d_model=3072 16H (GQA kv=16) d_ff=24576 vocab=256000
[arXiv:2403.08295; hf]

head_dim=256 (explicit, q-proj 3072→4096).  The 256-dim heads make the
order-2 feature state large (symvec D = 32 896) and lie outside the CUDA
kernels' envelope (head dim ≤ 128): under ``attn_impl="auto"`` the
attention runs the plain torch paths, and ``attn_impl="cuda"`` raises.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b",
    family="lm",
    d_model=3072,
    n_heads=16,
    n_kv_heads=16,
    d_ff=24576,
    vocab=256000,
    head_dim=256,
    act="geglu",
    embed_scale=True,
    tie_embeddings=True,
    pattern=("attn",),
    n_groups=28,
    attention="taylor",
    pos="rope",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        d_model=64, n_heads=4, n_kv_heads=4, head_dim=32, d_ff=128, vocab=128,
        n_groups=3, dtype="float32", remat="none", attn_chunk=16, max_seq=256,
    )
