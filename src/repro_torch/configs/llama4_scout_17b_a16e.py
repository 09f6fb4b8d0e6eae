"""llama4-scout-17b-a16e [moe] — MoE, early fusion
[hf:meta-llama/Llama-4-Scout-17B-16E].

48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048, MoE 16 experts top-1
(+ one shared expert, as in the Llama-4 MoE block).
"""

from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama4-scout-17b-a16e",
        family="moe",
        n_layers=48,
        d_model=5120,
        n_heads=40,
        n_kv_heads=8,
        head_dim=128,
        d_ff=8192,
        vocab_size=202048,
        act="silu",
        n_experts=16,
        top_k=1,
        moe_d_ff=8192,
        n_shared_experts=1,
        moe_period=1,
        rope_theta=500000.0,
        dtype="bfloat16",
        fsdp=True,
    )
