"""Model configuration — one frozen dataclass drives every architecture
family (dense / moe / ssm / hybrid / vlm / audio).

A field-for-field copy of the reference's ``repro.models.config`` (the port
imports nothing of ``repro``): ``ModelConfig`` and ``reduced`` give the same
values for every architecture, so a smoke config built by either package
describes the same model.  The port runs every family.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int = 2
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: int = 0  # 0 => d_model // n_heads
    d_ff: int = 1024
    vocab_size: int = 1024
    act: str = "silu"  # silu(-> SwiGLU) | squared_relu | gelu
    qkv_bias: bool = False
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    tie_embeddings: bool = False

    # rope
    rope_theta: float = 10000.0
    rope_mode: str = "standard"  # standard | mrope
    mrope_sections: tuple[int, ...] = ()  # splits of head_dim//2, e.g. (16,24,24)

    # attention variants
    sliding_window: int = 0  # 0 = full causal attention

    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    n_shared_experts: int = 0
    moe_period: int = 1  # layer i uses MoE iff n_experts>0 and i % moe_period == moe_offset
    moe_offset: int = 0
    capacity_factor: float = 1.25
    moe_group_size: int = 512  # GShard dispatch group (tokens)
    router_aux_weight: float = 0.01
    router_z_weight: float = 1e-3

    # SSM (mamba2 / SSD)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 64
    ssm_conv: int = 4
    # route the intra-chunk term through kernels.ops.ssd_chunked_fused: the
    # hand-written CUDA kernel for CUDA tensors, its plain version on the CPU
    ssd_fused: bool = False

    # hybrid layer pattern, repeated to n_layers; 'a' = attention, 'm' = mamba
    layer_pattern: tuple[str, ...] = ()

    # encoder-decoder (audio)
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    encoder_seq: int = 0  # e.g. whisper-tiny: 1500 frames
    max_target_positions: int = 0  # learned decoder positions (whisper: 448)

    # vlm stub
    n_patches: int = 0  # vision tokens prepended to the text sequence

    # numerics / distribution
    dtype: str = "float32"
    remat: bool = False
    remat_policy: str = "full"  # full | dots (save matmul outputs only)
    fsdp: bool = False
    # unroll the layer scan into straight-line HLO (used by the dry-run's
    # cost extrapolation: XLA's cost_analysis counts while bodies once)
    unroll: bool = False

    # ------------------------------------------------------------------
    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def pattern(self) -> tuple[str, ...]:
        if self.layer_pattern:
            return self.layer_pattern
        return ("m",) if self.family == "ssm" else ("a",)

    @property
    def block_len(self) -> int:
        """Layers per scanned super-block (pattern length, lcm'd with MoE period)."""
        p = len(self.pattern)
        if self.n_experts > 0 and self.moe_period > 1:
            # ensure the MoE period divides the super-block
            import math

            p = math.lcm(p, self.moe_period)
        return p

    @property
    def n_blocks(self) -> int:
        assert self.n_layers % self.block_len == 0, (
            self.n_layers,
            self.block_len,
        )
        return self.n_layers // self.block_len

    def layer_kind(self, i: int) -> str:
        return self.pattern[i % len(self.pattern)]

    def layer_is_moe(self, i: int) -> bool:
        return self.n_experts > 0 and (i % self.moe_period) == self.moe_offset

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        assert self.d_inner % self.ssm_head_dim == 0
        return self.d_inner // self.ssm_head_dim

    @property
    def has_ffn(self) -> bool:
        """Pure-SSM stacks (mamba2) have no separate FFN sub-layer (d_ff==0)."""
        return self.d_ff > 0 or self.n_experts > 0

    def n_params(self) -> int:
        """Analytic parameter count (embeddings included)."""
        d, hd = self.d_model, self.hd
        total = self.vocab_size * d  # embed
        if not self.tie_embeddings:
            total += self.vocab_size * d  # lm head
        for i in range(self.n_layers):
            kind = self.layer_kind(i)
            if kind == "a":
                total += d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd)
                total += (self.n_heads * hd) * d
                if self.qkv_bias:
                    total += (self.n_heads + 2 * self.n_kv_heads) * hd
                total += d  # norm
            else:  # mamba
                di, n, h = self.d_inner, self.ssm_state, self.ssm_heads
                total += d * (2 * di + 2 * n + h)  # in_proj (z,x,B,C,dt)
                total += self.ssm_conv * (di + 2 * n)  # depthwise conv
                total += 2 * h + di  # A_log, D, gated norm
                total += di * d  # out_proj
                total += d  # norm
            if self.has_ffn:
                total += d  # norm
                if self.layer_is_moe(i):
                    e, f = self.n_experts, self.moe_d_ff or self.d_ff
                    total += d * e  # router
                    total += e * (3 * d * f if self.act == "silu" else 2 * d * f)
                    if self.n_shared_experts:
                        fs = f * self.n_shared_experts
                        total += 3 * d * fs if self.act == "silu" else 2 * d * fs
                else:
                    f = self.d_ff
                    total += 3 * d * f if self.act == "silu" else 2 * d * f
        total += d  # final norm
        if self.is_encoder_decoder:
            for _ in range(self.n_encoder_layers):
                total += 4 * d * (self.n_heads * hd) + (
                    3 * d * self.d_ff if self.act == "silu" else 2 * d * self.d_ff
                ) + 2 * d
            # cross attention per decoder layer
            total += self.n_layers * (4 * d * (self.n_heads * hd) + d)
            total += self.max_target_positions * d  # learned positions
        return total

    def n_active_params(self) -> int:
        """Active params per token (MoE: top_k of n_experts)."""
        if self.n_experts == 0:
            return self.n_params()
        total = self.n_params()
        f = self.moe_d_ff or self.d_ff
        per_expert = 3 * self.d_model * f if self.act == "silu" else 2 * self.d_model * f
        n_moe_layers = sum(self.layer_is_moe(i) for i in range(self.n_layers))
        inactive = n_moe_layers * (self.n_experts - self.top_k) * per_expert
        return total - inactive


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Smoke-test variant of the same family: 2 blocks, d_model<=512, <=4 experts."""
    block = cfg.block_len
    small = dict(
        n_layers=2 * block if block > 1 else 2,
        d_model=min(cfg.d_model, 128),
        n_heads=min(cfg.n_heads, 4),
        n_kv_heads=min(cfg.n_kv_heads, 2),
        head_dim=32,
        d_ff=min(cfg.d_ff, 256) if cfg.d_ff else 0,
        vocab_size=min(cfg.vocab_size, 512),
        n_experts=min(cfg.n_experts, 4),
        top_k=min(cfg.top_k, 2),
        moe_d_ff=min(cfg.moe_d_ff, 128) if cfg.moe_d_ff else 0,
        ssm_state=min(cfg.ssm_state, 16) if cfg.ssm_state else 0,
        ssm_head_dim=16,
        ssm_chunk=8,
        n_encoder_layers=min(cfg.n_encoder_layers, 2),
        encoder_seq=min(cfg.encoder_seq, 32) if cfg.encoder_seq else 0,
        n_patches=min(cfg.n_patches, 16) if cfg.n_patches else 0,
        sliding_window=min(cfg.sliding_window, 16) if cfg.sliding_window else 0,
        max_target_positions=min(cfg.max_target_positions, 64)
        if cfg.max_target_positions
        else 0,
        dtype="float32",
        name=cfg.name + "-smoke",
        mrope_sections=(4, 6, 6) if cfg.rope_mode == "mrope" else (),
    )
    small.update(overrides)
    return dataclasses.replace(cfg, **small)
