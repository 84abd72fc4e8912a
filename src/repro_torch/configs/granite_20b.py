"""granite-20b [dense] — code model with MQA.

52L d_model=6144 48H (GQA kv=1) d_ff=24576 vocab=49152
[arXiv:2405.04324; hf]

MQA (kv=1) is the best case for the paper's technique: the Taylor moment
state is per-KV-head, so a single (d²·d_v) state serves all 48 query heads.
The FFN is the release's 2-matrix GELU MLP (gpt_bigcode lineage) — a gated
3-matrix FFN at d_ff=24576 would overshoot the 20B name by 8B params.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-20b",
    family="lm",
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    d_ff=24576,
    vocab=49152,
    act="gelu",
    pattern=("attn",),
    n_groups=52,
    attention="taylor",
    pos="rope",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        d_model=64, n_heads=4, n_kv_heads=1, d_ff=128, vocab=128,
        n_groups=3, dtype="float32", remat="none", attn_chunk=16, max_seq=256,
    )
