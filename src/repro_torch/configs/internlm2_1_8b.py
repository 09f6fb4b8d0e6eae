"""internlm2-1.8b [dense] — GQA [arXiv:2403.17297].

24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92544.
"""

from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="internlm2-1.8b",
        family="dense",
        n_layers=24,
        d_model=2048,
        n_heads=16,
        n_kv_heads=8,
        head_dim=128,
        d_ff=8192,
        vocab_size=92544,
        act="silu",
        rope_theta=1000000.0,
        dtype="bfloat16",
    )
