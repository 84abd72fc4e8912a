"""llama-3.2-vision-11b [vlm] — LM with interleaved image cross-attention.

40L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]

Cross-attention every 5th layer: pattern = 4×attn + 1×cross, 8 groups = 40
layers (8 cross-attention layers).  The vision tower is a stub, as in the
JAX package: requests and batches carry patch embeddings ``image_embeds``
[b, 1600, 1280]; a learned projector maps 1280 → d_model.  The cross
blocks keep the whole model off the CUDA kernels (the JAX package's
envelope), its head-dim-128 self-attention included.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=128256,
    pattern=("attn", "attn", "attn", "attn", "cross"),
    n_groups=8,
    n_image_tokens=1600,
    vision_dim=1280,
    attention="taylor",
    pos="rope",
    rope_theta=500000.0,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=128,
        pattern=("attn", "cross"), n_groups=2, n_image_tokens=16, vision_dim=32,
        dtype="float32", remat="none", attn_chunk=16, max_seq=256,
    )
