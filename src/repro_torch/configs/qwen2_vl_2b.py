"""qwen2-vl-2b [vlm] — M-RoPE, dynamic resolution [arXiv:2409.12191].

28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936.

The vision encoder (ViT + merger) is a stub, as in the reference: the caller
supplies precomputed patch embeddings (B, n_patches, d_model)
(``batch["patch_embeds"]``).
The language decoder with M-RoPE (temporal/height/width sections of the
rotary frequencies) is implemented in full.
"""

from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-2b",
        family="vlm",
        n_layers=28,
        d_model=1536,
        n_heads=12,
        n_kv_heads=2,
        head_dim=128,
        d_ff=8960,
        vocab_size=151936,
        act="silu",
        qkv_bias=True,
        tie_embeddings=True,
        rope_mode="mrope",
        mrope_sections=(16, 24, 24),  # of head_dim//2 = 64
        n_patches=1024,  # stubbed vision prefix length
        rope_theta=1000000.0,
        dtype="bfloat16",
    )
