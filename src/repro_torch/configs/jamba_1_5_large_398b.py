"""jamba-1.5-large-398b [hybrid] — Mamba+attn 1:7 interleave, MoE
[arXiv:2403.19887].

72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536, MoE 16e top-2.
Layer pattern: period-8 blocks with attention at in-block index 3 and Mamba2
elsewhere (1 attention : 7 mamba); MoE replaces the dense FFN on every other
layer (odd in-block indices).
"""

from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="jamba-1.5-large-398b",
        family="hybrid",
        n_layers=72,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        head_dim=128,
        d_ff=24576,
        vocab_size=65536,
        act="silu",
        layer_pattern=("m", "m", "m", "a", "m", "m", "m", "m"),
        n_experts=16,
        top_k=2,
        moe_d_ff=24576,
        moe_period=2,
        moe_offset=1,
        ssm_state=128,
        ssm_head_dim=64,
        ssm_expand=2,
        ssm_chunk=256,
        dtype="bfloat16",
        fsdp=True,
        remat=True,
    )
