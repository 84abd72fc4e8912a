"""mamba2-780m [ssm] — attention-free SSD (state-space duality).

48L d_model=1536 d_ff=0 vocab=50280 ssm_state=128
[arXiv:2405.21060; unverified]

Attention-free: the paper's attention technique does not apply.  SSD is
linear attention with a per-step decay, computed by the same kind of
chunked scan (``models/ssm.py``).
"""

from repro_torch.models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-780m",
    family="lm",
    d_model=1536,
    n_heads=1,
    n_kv_heads=1,
    d_ff=0,
    vocab=50280,
    pattern=("mamba",),
    n_groups=48,
    ssm=SSMConfig(d_state=128, expand=2, head_dim=64, conv_width=4, n_groups=1),
    pos="none",
    tie_embeddings=True,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        d_model=64, vocab=128, n_groups=3,
        ssm=SSMConfig(d_state=16, expand=2, head_dim=16, conv_width=4),
        dtype="float32", remat="none", attn_chunk=16, max_seq=256,
    )
