"""whisper-tiny [audio] — enc-dec, conv frontend (stub) [arXiv:2212.04356].

4L d_model=384 6H (kv=6) d_ff=1536 vocab=51865; 4 encoder layers; 1500
audio frames; 448 learned decoder positions; GELU; LayerNorm; tied head.

The mel-spectrogram + conv downsampler frontend is a stub, as in the
reference: the caller supplies frame embeddings (B, 1500, 384)
(``batch["frames"]``).
"""

from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-tiny",
        family="audio",
        is_encoder_decoder=True,
        n_layers=4,
        n_encoder_layers=4,
        d_model=384,
        n_heads=6,
        n_kv_heads=6,
        head_dim=64,
        d_ff=1536,
        vocab_size=51865,
        act="gelu",
        norm="layernorm",
        encoder_seq=1500,
        max_target_positions=448,
        tie_embeddings=True,
        dtype="bfloat16",
    )
