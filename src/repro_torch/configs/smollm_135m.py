"""smollm-135m [dense] — llama-arch small [hf:HuggingFaceTB/SmolLM-135M].

30L d_model=576 9H (GQA kv=3) d_ff=1536 vocab=49152.
"""

from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="smollm-135m",
        family="dense",
        n_layers=30,
        d_model=576,
        n_heads=9,
        n_kv_heads=3,
        head_dim=64,
        d_ff=1536,
        vocab_size=49152,
        act="silu",
        tie_embeddings=True,
        rope_theta=10000.0,
        dtype="bfloat16",
    )
