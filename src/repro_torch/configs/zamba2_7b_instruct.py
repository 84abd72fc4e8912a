"""zamba2-7b-instruct [hybrid] — Zamba2-7B-Instruct as released.

81 mamba layers d_model=3584 (d_inner 7168, 112 SSD heads of 64, d_state
64, 2 B/C groups, conv 4) vocab=32000 context 4096, RMSNorm eps 1e-5, tied
head [huggingface.co/Zyphra/Zamba2-7B-Instruct config.json; the layer
equations of transformers' ``modeling_zamba2.py``]

13 hybrid sites (``hybrid_layer_ids``) run a shared block before their
mamba layer, taking the 2 shared blocks in turn (0, 1, 0, 1, ...).  A
shared block reads ``cat(x, x0)`` (7168 wide; x0 is the embedding output):
RMSNorm(7168), attention with q, k, v 7168 → 32 heads of 224 and RoPE over
224, o back to 3584, RMSNorm(3584), and the gated exact-GELU MLP (d_ff
14336, no biases) whose gate_up the site's own rank-128 adapter adds to.
It has no residual: the site's own 3584 × 3584 linear takes its output to
the input of the site's mamba block, before that block's norm.  The
paper's order-2 Taylor attention (alpha 3) takes the place of the softmax;
at head dim 224, past the CUDA kernels' 128, training runs the torch
chunked scan.  7,356,749,648 parameters.

Not among ``ARCHS``: the registry lists the JAX package's ten architectures,
whose ``zamba2-7b`` is a simplified layout (``configs/zamba2_7b.py``).
"""

from repro_torch.core.feature_map import TaylorConfig
from repro_torch.models.config import ModelConfig, SiteConfig, SSMConfig

HYBRID_LAYER_IDS = (6, 11, 17, 23, 29, 35, 41, 47, 53, 59, 65, 71, 77)

CONFIG = ModelConfig(
    name="zamba2-7b-instruct",
    family="lm",
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    head_dim=224,
    d_ff=14336,
    vocab=32000,
    pattern=("mamba",),
    n_groups=81,
    act="geglu_erf",
    norm="rmsnorm",
    norm_eps=1e-5,
    tie_embeddings=True,
    pos="rope",
    rope_theta=10000.0,
    attention="taylor",
    taylor=TaylorConfig(order=2, alpha=3.0),
    attn_chunk=256,  # the release's SSD chunk; the Taylor scan's chunk too
    ssm=SSMConfig(d_state=64, expand=2, head_dim=64, conv_width=4, n_groups=2),
    sites=SiteConfig(layer_ids=HYBRID_LAYER_IDS, n_blocks=2, adapter_rank=128),
    max_seq=4096,
)


def reduced() -> ModelConfig:
    """A CPU-sized form: 10 mamba layers, 4 sites over 2 shared blocks,
    2 B/C groups, adapter rank 4, head dim 32 over 2·64."""
    return CONFIG.replace(
        d_model=64,
        n_heads=4,
        head_dim=32,
        n_kv_heads=4,
        d_ff=96,
        vocab=128,
        n_groups=10,
        ssm=SSMConfig(d_state=8, expand=2, head_dim=16, conv_width=4, n_groups=2),
        sites=SiteConfig(layer_ids=(1, 3, 6, 8), n_blocks=2, adapter_rank=4),
        dtype="float32",
        remat="none",
        attn_chunk=16,
        max_seq=256,
    )
