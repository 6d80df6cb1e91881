"""Architecture + input-shape config system, without JAX.

Every architecture the reference knows has one module in this package
exporting ``CONFIG: ArchConfig``, with the reference's fields, names and
defaults (``repro/configs/base.py``).  ``reduced()`` derives the CPU smoke
variant (<=2 layers, d_model<=256, <=4 experts) of the same family.  The
CNN family re-purposes ``d_model`` as the base conv width, ``d_ff`` as the
dense hidden width and ``vocab_size`` as the class count.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    expert_d_ff: int
    # capacity factor for dispatch; tokens-per-expert slots = tokens*top_k/E*cf
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    # load-balance auxiliary loss weight (Switch-style)
    aux_loss_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_inner: int          # expanded inner width (mamba: 2*d_model)
    state_dim: int        # N in mamba (ssm_state)
    conv_width: int = 4
    dt_rank: int = 0      # 0 -> ceil(d_model/16)


@dataclasses.dataclass(frozen=True)
class HybridConfig:
    """RecurrentGemma-style repeating block pattern ('rglru' or 'attn')."""
    pattern: tuple = ("rglru", "rglru", "attn")
    lru_width: int = 0          # 0 -> d_model
    attn_window: int = 2048


@dataclasses.dataclass(frozen=True)
class EncDecConfig:
    n_enc_layers: int
    n_dec_layers: int
    # stubbed modality frontend: inputs are precomputed frame embeddings
    n_frames: int = 4096


@dataclasses.dataclass(frozen=True)
class VLMConfig:
    # stubbed vision tower: inputs include precomputed patch embeddings
    n_patches: int = 1024
    patch_embed_dim: int = 1024   # projector input dim (vision tower output)


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | encdec | vlm | cnn
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    norm: str = "rmsnorm"          # rmsnorm | layernorm
    activation: str = "swiglu"     # swiglu | gelu | geglu | relu
    tie_embeddings: bool = False
    sliding_window: Optional[int] = None   # None -> full causal attention
    dtype: str = "bfloat16"
    # unembedding matmul in param dtype, logits upcast afterwards; False =
    # float32 matmul
    logits_bf16: bool = False
    # MoE decode path: "dispatch" (one-hot contraction over every expert)
    # or "gather" (index the top-k experts' weights per token)
    moe_decode: str = "dispatch"
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid: Optional[HybridConfig] = None
    encdec: Optional[EncDecConfig] = None
    vlm: Optional[VLMConfig] = None
    source: str = ""               # citation for the config numbers

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def param_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def n_params(self) -> int:
        """Approximate parameter count (embedding + blocks + head)."""
        d, ff, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.resolved_head_dim
        emb = v * d * (1 if self.tie_embeddings else 2)
        if self.family == "ssm":
            s = self.ssm
            dtr = s.dt_rank or max(1, -(-self.d_model // 16))
            per = (d * 2 * s.d_inner            # in_proj (x and z)
                   + s.d_inner * s.conv_width   # conv1d
                   + s.d_inner * (dtr + 2 * s.state_dim)  # x_proj
                   + dtr * s.d_inner            # dt_proj
                   + s.d_inner * s.state_dim    # A_log
                   + s.d_inner                  # D
                   + s.d_inner * d              # out_proj
                   + d)                         # norm
            return emb + self.n_layers * per
        attn = d * (self.n_heads * hd) + d * (2 * self.n_kv_heads * hd) \
            + (self.n_heads * hd) * d
        if self.activation in ("swiglu", "geglu"):
            mlp_dense = 3 * d * ff
        else:
            mlp_dense = 2 * d * ff
        if self.family == "moe":
            m = self.moe
            eff = m.n_experts * (3 * d * m.expert_d_ff) + d * m.n_experts
            per = attn + eff + 2 * d
        elif self.family == "hybrid":
            h = self.hybrid
            lw = h.lru_width or d
            rec = d * 2 * lw + lw * d + 3 * lw  # gates are per-channel
            n_attn = self.n_layers // len(h.pattern) * sum(
                1 for p in h.pattern if p == "attn")
            n_rec = self.n_layers - n_attn
            return emb + n_attn * (attn + mlp_dense + 2 * d) \
                + n_rec * (rec + mlp_dense + 2 * d)
        else:
            per = attn + mlp_dense + 2 * d
        if self.family == "encdec":
            # encoder layer: attn+mlp; decoder layer: self+cross attn + mlp
            e = self.encdec
            return emb + e.n_enc_layers * (attn + mlp_dense + 2 * d) \
                + e.n_dec_layers * (2 * attn + mlp_dense + 3 * d)
        return emb + self.n_layers * per

    def n_active_params(self) -> int:
        """Active params per token (MoE: only top_k experts count)."""
        if self.family != "moe":
            return self.n_params()
        m = self.moe
        d = self.d_model
        total = self.n_params()
        all_experts = self.n_layers * m.n_experts * 3 * d * m.expert_d_ff
        active = self.n_layers * m.top_k * 3 * d * m.expert_d_ff
        return total - all_experts + active

    def reduced(self) -> "ArchConfig":
        """Smoke-test variant: same family/topology, tiny dims."""
        d = min(self.d_model, 256)
        n_heads = min(self.n_heads, 4)
        n_kv = max(0, min(self.n_kv_heads, n_heads))
        kw = dict(
            name=self.name + "-smoke",
            family=self.family,
            n_layers=min(self.n_layers, 2),
            d_model=d,
            n_heads=n_heads,
            n_kv_heads=n_kv,
            head_dim=d // n_heads if n_heads else 0,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            qkv_bias=self.qkv_bias,
            rope_theta=self.rope_theta,
            norm=self.norm,
            activation=self.activation,
            tie_embeddings=self.tie_embeddings,
            sliding_window=min(self.sliding_window, 64)
            if self.sliding_window else None,
            dtype="float32",
            source=self.source,
        )
        if self.moe:
            kw["moe"] = dataclasses.replace(
                self.moe, n_experts=min(self.moe.n_experts, 4),
                top_k=min(self.moe.top_k, 2),
                expert_d_ff=min(self.moe.expert_d_ff, 128))
        if self.ssm:
            kw["ssm"] = dataclasses.replace(
                self.ssm, d_inner=2 * d, state_dim=min(self.ssm.state_dim, 8),
                dt_rank=max(1, d // 16))
        if self.hybrid:
            kw["hybrid"] = dataclasses.replace(
                self.hybrid, lru_width=d, attn_window=64)
        if self.encdec:
            kw["encdec"] = dataclasses.replace(
                self.encdec, n_enc_layers=2, n_dec_layers=2, n_frames=32)
        if self.vlm:
            kw["vlm"] = dataclasses.replace(
                self.vlm, n_patches=16, patch_embed_dim=64)
        if self.family == "hybrid":
            kw["n_layers"] = 3   # one full pattern
        return ArchConfig(**kw)


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str               # train | prefill | decode

    def reduced(self) -> "InputShape":
        return InputShape(self.name + "-smoke", min(self.seq_len, 64),
                          min(self.global_batch, 2), self.kind)


TRAIN_4K = InputShape("train_4k", 4_096, 256, "train")
PREFILL_32K = InputShape("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = InputShape("decode_32k", 32_768, 128, "decode")
LONG_500K = InputShape("long_500k", 524_288, 1, "decode")

INPUT_SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K,
                                    LONG_500K)}
