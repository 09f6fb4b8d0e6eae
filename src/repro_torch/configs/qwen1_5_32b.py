"""qwen1.5-32b [dense] — QKV bias [hf:Qwen/Qwen1.5-0.5B family].

64L d_model=5120 40H (MHA kv=40) d_ff=27392 vocab=152064.
"""

from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-32b",
        family="dense",
        n_layers=64,
        d_model=5120,
        n_heads=40,
        n_kv_heads=40,
        head_dim=128,
        d_ff=27392,
        vocab_size=152064,
        act="silu",
        qkv_bias=True,
        rope_theta=1000000.0,
        dtype="bfloat16",
        fsdp=True,
        remat=True,
    )
