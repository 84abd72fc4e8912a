"""zamba2-7b [hybrid] — Mamba2 backbone + one shared attention block.

81L d_model=3584 32H (GQA kv=32) d_ff=14336 vocab=32000 ssm_state=64
[arXiv:2411.15242; unverified]

Zamba2 interleaves a single weight-SHARED attention + MLP block into a
Mamba2 stack: 11 groups of (6 mamba + 1 shared_attn) and a 4-mamba tail
(11·7 + 4 = 81 blocks).  The real model's per-occurrence LoRA deltas on the
shared block are omitted.  head_dim = 3584/32 = 112, which the Taylor
kernels' wrapper zero-pads to 128.
"""

from repro_torch.models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="lm",
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14336,
    vocab=32000,
    pattern=("mamba",) * 6 + ("shared_attn",),
    n_groups=11,
    tail=("mamba",) * 4,
    ssm=SSMConfig(d_state=64, expand=2, head_dim=64, conv_width=4, n_groups=1),
    attention="taylor",  # the paper's technique on the shared attention block
    pos="rope",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        vocab=128,
        pattern=("mamba", "mamba", "shared_attn"),
        n_groups=2,
        tail=("mamba",),
        ssm=SSMConfig(d_state=8, expand=2, head_dim=16, conv_width=4),
        dtype="float32",
        remat="none",
        attn_chunk=16,
        max_seq=256,
    )
