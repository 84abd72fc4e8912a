"""whisper-medium [audio] — encoder-decoder with a (stubbed) conv front end.

24L(enc)+24L(dec) d_model=1024 16H d_ff=4096 vocab=51865
[arXiv:2212.04356; unverified]

The conv front end is a stub, as in the JAX package: requests and batches
carry precomputed frame embeddings ``audio_frames`` [b, 1500, 1024].
Positions are sinusoidal on both sides.  Decoder layers: self-attention +
cross-attention + MLP (the "cross" kind), layernorm, 2-matrix GELU MLP.
The cross blocks keep the whole model off the CUDA kernels (the JAX
package's envelope): under ``attn_impl="auto"`` it runs the torch paths,
and ``attn_impl="cuda"`` raises.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    family="encdec",
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab=51865,
    pattern=("cross",),
    n_groups=24,
    encoder_pattern=("attn",),
    n_encoder_groups=24,
    n_audio_ctx=1500,
    norm="layernorm",
    norm_eps=1e-5,
    act="gelu",
    pos="sinusoidal",
    tie_embeddings=True,
    attention="taylor",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab=128,
        n_groups=2, n_encoder_groups=2, n_audio_ctx=24,
        dtype="float32", remat="none", attn_chunk=16, max_seq=256,
    )
