"""smollm-135m [dense] — small llama-arch model.

30L d_model=576 9H (GQA kv=3) d_ff=1536 vocab=49152
[hf:HuggingFaceTB/SmolLM-135M; hf]
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="smollm-135m",
    family="lm",
    d_model=576,
    n_heads=9,
    n_kv_heads=3,
    d_ff=1536,
    vocab=49152,
    pattern=("attn",),
    n_groups=30,
    tie_embeddings=True,
    attention="taylor",
    pos="rope",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=128,
        n_groups=3, dtype="float32", remat="none", attn_chunk=16, max_seq=256,
    )
