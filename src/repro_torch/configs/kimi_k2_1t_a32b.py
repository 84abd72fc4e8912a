"""kimi-k2-1t-a32b [moe] — trillion-parameter MoE (paper-table config).

61L d_model=7168 64H (GQA kv=8) d_ff=2048(per expert) vocab=163840,
MoE 384 experts top-8  [arXiv:2501.kimi2; unverified]

Mapping notes: all 61 blocks are MoE (the released model's single leading
dense block is folded into the pattern); 1 shared expert (d_ff 2048) as in
the release; head_dim=128 explicit (the release uses MLA — out of scope;
GQA kv=8).  One full-width block holds 384 × 3 × 7168 × 2048 ≈ 16.9 B
expert params (33.8 GB in bf16): at full width the experts split over the
mesh's "model" axis (``impl="auto"`` runs ``ep_a2a`` on a mesh);
``reduced()`` runs on one device.
"""

from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="lm",
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=2048,
    vocab=163840,
    pattern=("moe",),
    n_groups=61,
    moe=MoEConfig(
        n_experts=384,
        top_k=8,
        d_ff_expert=2048,
        n_shared_experts=1,
        d_ff_shared=2048,
        capacity_factor=1.25,
    ),
    attention="taylor",
    pos="rope",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=32, vocab=128,
        n_groups=2,
        moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=32, n_shared_experts=1,
                      d_ff_shared=32, impl="dense"),
        dtype="float32", remat="none", attn_chunk=16, max_seq=256,
    )
