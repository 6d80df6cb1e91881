"""The latent-attention MoE family (DeepSeek-V2's block), a port-only
config type.

The family's block (arXiv:2405.04434): multi-head latent attention
(MLA) with a decoupled RoPE key under YaRN's frequencies, then either a
dense SwiGLU MLP (the first ``first_k_dense`` layers) or DeepSeekMoE:
routed experts chosen greedily by a float32 softmax, with shared
experts beside them on every token, trained with the sequence-wise
balance loss.  :class:`MLAMoEConfig` is an :class:`ArchConfig` with the
MLA, YaRN and MoE settings in groups of their own, so the reference's
``ArchConfig`` and ``MoEConfig`` keep their fields.

``head_dim`` is the width of a head's non-rotary query and key part and
of its value (``qk_nope_head_dim`` and ``v_head_dim``, equal in every
published model of the family); the rotary part (``qk_rope_head_dim``)
is one head shared by all heads, so ``n_kv_heads`` equals ``n_heads``.
``d_ff`` is the dense layers' width.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

from repro_torch.configs.base import ArchConfig


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int             # the latent c_kv's width
    qk_rope_head_dim: int         # the decoupled RoPE key's (one head)


@dataclasses.dataclass(frozen=True)
class YarnConfig:
    """YaRN's RoPE extension (arXiv:2309.00071), DeepSeek-V2's form."""
    factor: float
    original_max_position_embeddings: int
    beta_fast: float
    beta_slow: float
    mscale: float
    mscale_all_dim: float


@dataclasses.dataclass(frozen=True)
class DeepSeekMoEConfig:
    n_routed_experts: int
    top_k: int
    expert_d_ff: int              # a routed expert's width
    n_shared_experts: int         # one MLP n_shared_experts * expert_d_ff wide
    first_k_dense: int            # leading layers with a dense MLP
    routed_scaling_factor: float = 1.0
    norm_topk_prob: bool = False
    aux_loss_alpha: float = 0.001  # the sequence-wise balance loss's weight


@dataclasses.dataclass(frozen=True)
class MLAMoEConfig(ArchConfig):
    mla: Optional[MLAConfig] = None
    yarn: Optional[YarnConfig] = None
    dsmoe: Optional[DeepSeekMoEConfig] = None

    @property
    def n_moe_layers(self) -> int:
        return self.n_layers - self.dsmoe.first_k_dense

    def n_params(self) -> int:
        """Every parameter: the embedding, the head and the blocks."""
        d, H, hd = self.d_model, self.n_heads, self.resolved_head_dim
        r, rope = self.mla.kv_lora_rank, self.mla.qk_rope_head_dim
        m = self.dsmoe
        attn = d * H * (hd + rope) + d * (r + rope) + r \
            + r * H * 2 * hd + H * hd * d
        dense = attn + 3 * d * self.d_ff + 2 * d
        moe = attn + 2 * d + d * m.n_routed_experts \
            + 3 * d * m.expert_d_ff * (m.n_routed_experts + m.n_shared_experts)
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return emb + d + m.first_k_dense * dense + self.n_moe_layers * moe

    def reduced(self) -> "MLAMoEConfig":
        """The CPU variant: 3 layers (1 dense), d 64, 4 heads, kv rank 16,
        nope and value 16, rope 8, 8 experts top-2 of width 32 with 1
        shared, vocab 256, float32."""
        return dataclasses.replace(
            self, name=self.name + "-smoke", n_layers=3, d_model=64,
            n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128, vocab_size=256,
            dtype="float32",
            mla=MLAConfig(kv_lora_rank=16, qk_rope_head_dim=8),
            dsmoe=dataclasses.replace(self.dsmoe, n_routed_experts=8,
                                      top_k=2, expert_d_ff=32,
                                      n_shared_experts=1, first_k_dense=1))


# ------------------------------------------------------------------ YaRN

def yarn_correction_dim(num_rotations: float, dim: int, base: float,
                        max_pos: int) -> float:
    """The rotary dimension whose wavelength fits ``num_rotations`` turns
    into ``max_pos`` positions."""
    return dim * math.log(max_pos / (num_rotations * 2 * math.pi)) \
        / (2 * math.log(base))


def yarn_correction_range(beta_fast: float, beta_slow: float, dim: int,
                          base: float, max_pos: int) -> tuple[int, int]:
    """(low, high) pair indices of YaRN's ramp between extrapolated and
    interpolated frequencies."""
    low = math.floor(yarn_correction_dim(beta_fast, dim, base, max_pos))
    high = math.ceil(yarn_correction_dim(beta_slow, dim, base, max_pos))
    return max(low, 0), min(high, dim - 1)


def yarn_mscale(scale: float, mscale: float) -> float:
    return 1.0 if scale <= 1 else 0.1 * mscale * math.log(scale) + 1.0


def softmax_scale(cfg: MLAMoEConfig) -> float:
    """``(nope + rope) ** -0.5 * mscale ** 2`` with YaRN's ``mscale`` of
    ``mscale_all_dim``."""
    m = yarn_mscale(cfg.yarn.factor, cfg.yarn.mscale_all_dim)
    return (cfg.resolved_head_dim + cfg.mla.qk_rope_head_dim) ** -0.5 * m * m


def rope_cos_sin_factor(cfg: MLAMoEConfig) -> float:
    """The factor on cos and sin: ``mscale(mscale) / mscale(mscale_all_dim)``
    (1 where the two are equal, as in DeepSeek-V2)."""
    y = cfg.yarn
    return yarn_mscale(y.factor, y.mscale) / yarn_mscale(y.factor,
                                                         y.mscale_all_dim)
