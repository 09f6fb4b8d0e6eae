"""qwen3-moe-30b-a3b [moe] — 128 experts top-8 [hf:Qwen/Qwen3-30B-A3B].

48L d_model=2048 32H (GQA kv=4) per-expert d_ff=768 vocab=151936,
MoE 128 experts top-8 on every layer (no shared expert, no dense layers).
"""

from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-30b-a3b",
        family="moe",
        n_layers=48,
        d_model=2048,
        n_heads=32,
        n_kv_heads=4,
        head_dim=128,
        d_ff=768,
        vocab_size=151936,
        act="silu",
        n_experts=128,
        top_k=8,
        moe_d_ff=768,
        moe_period=1,
        rope_theta=1000000.0,
        dtype="bfloat16",
        fsdp=True,
    )
