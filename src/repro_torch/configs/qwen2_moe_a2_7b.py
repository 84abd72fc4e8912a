"""qwen2-moe-a2.7b [moe] — 4 shared + 60 routed experts, top-4.

24L d_model=2048 16H (GQA kv=16) d_ff=1408(per expert) vocab=151936
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]

The 4 always-on shared experts are modelled as one fused shared MLP with
hidden 4×1408 = 5632 (identical compute/params to 4 parallel experts).
"""

from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="lm",
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab=151936,
    pattern=("moe",),
    n_groups=24,
    qkv_bias=True,
    moe=MoEConfig(
        n_experts=60,
        top_k=4,
        d_ff_expert=1408,
        n_shared_experts=4,
        d_ff_shared=5632,
        capacity_factor=1.25,
    ),
    attention="taylor",
    pos="rope",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        d_model=64, n_heads=4, n_kv_heads=4, d_ff=32, vocab=128,
        n_groups=2,
        moe=MoEConfig(n_experts=6, top_k=2, d_ff_expert=32, n_shared_experts=2,
                      d_ff_shared=64, impl="dense"),
        dtype="float32", remat="none", attn_chunk=16, max_seq=256,
    )
