"""The latent-attention MoE family: DeepSeek-V2's decoder (arXiv:2405.04434;
``configs/mla_moe.py`` holds its settings).  A port-only family: the
reference has no latent attention and no dropless MoE.

A layer is ``x + attn(rmsnorm(x))`` then ``x + ffn(rmsnorm(x))``:

* **MLA.** ``q = x Wq`` per head ``[q_nope (head_dim), q_pe (rope)]``;
  ``[c_kv, k_pe] = x Wkv_a``, ``c_kv`` the latent (``kv_lora_rank``) and
  ``k_pe`` one rotary key shared by every head; ``[k_nope, v] =
  rmsnorm(c_kv) Wkv_b`` per head.  RoPE rotates ``q_pe`` and ``k_pe`` in
  DeepSeek's interleaved layout (each pair ``(2i, 2i+1)`` taken apart
  into the two halves, then the half-split rotation) at YaRN's
  frequencies; the heads attend over ``k = [k_nope, k_pe]`` with the
  scale ``(head_dim + rope) ** -0.5 * mscale ** 2``; the output is ``o
  Wo``.  Training attends through ``attention.attend`` with the shared
  rotary key expanded over the heads.
* **FFN.** The first ``first_k_dense`` layers hold a SwiGLU MLP of
  ``d_ff``; the rest DeepSeekMoE: the router's weight stored in the
  parameters' dtype and applied in float32, a softmax over the routed
  experts, the greedy top-k with its scores as weights (times
  ``routed_scaling_factor``; renormalised only where ``norm_topk_prob``),
  and no assignment dropped: the token x top-k assignments sorted by
  expert run through one grouped GEMM a projection
  (``kernels/ops.grouped_mm_op``) and are added back weighted; the shared
  experts' MLP runs on every token beside them.
* **Balance loss** (DeepSeek-V2's sequence-wise one): ``alpha *
  mean_b sum_i f_bi P_bi`` a MoE layer, ``f_bi`` row ``b``'s count of
  assignments to expert ``i`` times ``E / (S K)`` (no gradient), ``P_bi``
  the row's mean of expert ``i``'s score.  :func:`forward` returns the
  layers' sum beside the logits, and ``registry.loss_fn`` adds it to the
  loss the step differentiates and returns.

The parameters: ``embed``, ``dense`` (the leading dense layers, stacked),
``blocks`` (the MoE layers, stacked), ``ln_f``, ``unembed``.  The family
computes on whole tensors: a ``DTensor`` leaf or batch is gathered once
a step (``full_tensor``, differentiable).  Nothing reads a count on the
host in the forward or backward, but the counters, while a recorder is
active.  The serve path (a latent KV cache for prefill and decode) is
not written: :func:`init_cache` and :func:`decode` raise.

Spans (``telemetry/wallclock``): ``mla.project`` (the projections in
and RoPE), ``mla.attend`` (attention and ``Wo``), ``moe.route``,
``moe.dispatch`` (sort and gather), ``moe.experts`` (the grouped GEMMs
and SwiGLU), ``moe.combine`` (unsort and weighted sum), ``moe.shared``.
Counters, a MoE layer's forward (not its recompute in the backward):
``moe.rows`` (assignments), ``moe.rows_max`` (the busiest expert's rows)
and ``moe.dropped`` (assignments past the last group's end, which no
expert multiplies: 0 by construction, an assertion that the groups
cover every row).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import sharding as shd
from repro_torch.configs.mla_moe import (MLAMoEConfig, rope_cos_sin_factor,
                                         softmax_scale,
                                         yarn_correction_range)
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.attention import attend
from repro_torch.telemetry import wallclock
from repro_torch.utils.pytree import tree_leaves, tree_map


# ------------------------------------------------------------------ init

def init_mla(gen: torch.Generator, cfg: MLAMoEConfig) -> dict:
    d, H, hd = cfg.d_model, cfg.n_heads, cfg.resolved_head_dim
    r, rope = cfg.mla.kv_lora_rank, cfg.mla.qk_rope_head_dim
    dt = cfg.param_dtype
    return {
        "wq": L.init_linear(gen, d, H * (hd + rope), dtype=dt,
                            axes=("fsdp", "tp")),
        "wkv_a": L.init_linear(gen, d, r + rope, dtype=dt,
                               axes=("fsdp", "none")),
        "kv_norm": L.init_norm(gen, r, dtype=dt),
        "wkv_b": L.init_linear(gen, r, H * 2 * hd, dtype=dt,
                               axes=("none", "tp")),
        "wo": L.init_linear(gen, H * hd, d, dtype=dt, axes=("tp", "fsdp")),
    }


def init_dense_block(gen: torch.Generator, cfg: MLAMoEConfig) -> dict:
    dt = cfg.param_dtype
    return {"ln_attn": L.init_norm(gen, cfg.d_model, dtype=dt),
            "attn": init_mla(gen, cfg),
            "ln_mlp": L.init_norm(gen, cfg.d_model, dtype=dt),
            "mlp": L.init_mlp(gen, cfg.d_model, cfg.d_ff, dtype=dt)}


def init_moe_block(gen: torch.Generator, cfg: MLAMoEConfig) -> dict:
    m, d, dt = cfg.dsmoe, cfg.d_model, cfg.param_dtype
    E, f = m.n_routed_experts, m.expert_d_ff
    return {
        "ln_attn": L.init_norm(gen, d, dtype=dt),
        "attn": init_mla(gen, cfg),
        "ln_mlp": L.init_norm(gen, d, dtype=dt),
        "router": {"w": L.param(gen, (d, E), ("fsdp", "experts"), dtype=dt)},
        "experts": {
            "w_gate": L.param(gen, (E, d, f),
                              ("experts", "expert_in", "expert_ff"),
                              dtype=dt),
            "w_up": L.param(gen, (E, d, f),
                            ("experts", "expert_in", "expert_ff"), dtype=dt),
            "w_down": L.param(gen, (E, f, d),
                              ("experts", "expert_ff", "expert_in"),
                              dtype=dt)},
        "shared": L.init_mlp(gen, d, m.n_shared_experts * f, dtype=dt),
    }


def init_lm(gen: torch.Generator, cfg: MLAMoEConfig) -> dict:
    p = {
        "embed": L.init_embedding(gen, cfg.vocab_size, cfg.d_model,
                                  dtype=cfg.param_dtype),
        "dense": T.init_stack(gen, cfg.dsmoe.first_k_dense,
                              lambda g: init_dense_block(g, cfg)),
        "blocks": T.init_stack(gen, cfg.n_moe_layers,
                               lambda g: init_moe_block(g, cfg)),
        "ln_f": L.init_norm(gen, cfg.d_model, dtype=cfg.param_dtype),
    }
    if not cfg.tie_embeddings:
        p["unembed"] = L.init_linear(gen, cfg.d_model, cfg.vocab_size,
                                     dtype=cfg.param_dtype,
                                     axes=("fsdp", "tp"))
    return p


# ------------------------------------------------------------------ RoPE

def yarn_inv_freq(cfg: MLAMoEConfig, device=None) -> torch.Tensor:
    """The rotary pairs' frequencies (rope / 2,): ``theta ** (-2i / rope)``
    below YaRN's ramp, those over ``factor`` above it, a linear blend
    across it."""
    dim, base = cfg.mla.qk_rope_head_dim, cfg.rope_theta
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    extra = 1.0 / base ** exps
    y = cfg.yarn
    inter = 1.0 / (y.factor * base ** exps)
    low, high = yarn_correction_range(y.beta_fast, y.beta_slow, dim, base,
                                      y.original_max_position_embeddings)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(dim // 2, dtype=torch.float32, device=device)
             - low) / (high - low)).clamp(0.0, 1.0)
    keep = 1.0 - ramp
    return inter * (1.0 - keep) + extra * keep


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               cfg: MLAMoEConfig) -> torch.Tensor:
    """DeepSeek's interleaved RoPE.  x (B, S, h, rope), positions (B, S):
    the pairs ``(2i, 2i+1)`` taken apart into the two halves, then the
    half-split rotation, in float32; the result stays in that layout
    (query and key alike, so their products are unchanged)."""
    B, S, h, dr = x.shape
    x = x.reshape(B, S, h, dr // 2, 2).transpose(-1, -2).reshape(B, S, h, dr)
    ang = positions[..., None].float() * yarn_inv_freq(cfg, x.device)
    f = rope_cos_sin_factor(cfg)
    cos = (torch.cos(ang) * f)[..., None, :]
    sin = (torch.sin(ang) * f)[..., None, :]
    x1, x2 = x[..., :dr // 2].float(), x[..., dr // 2:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     -1).to(x.dtype)


# ------------------------------------------------------------------- MLA

def mla_residual(p: dict, x: torch.Tensor, positions: torch.Tensor,
                 cfg: MLAMoEConfig, *, causal_skip: bool = False
                 ) -> torch.Tensor:
    """``x + Wo attend(q, [k_nope, k_pe], v)`` of a layer ``p`` (its
    ``ln_attn`` and ``attn``).  x (B, S, D), positions (B, S)."""
    a = p["attn"]
    B, S, _ = x.shape
    H, hd = cfg.n_heads, cfg.resolved_head_dim
    r, rope = cfg.mla.kv_lora_rank, cfg.mla.qk_rope_head_dim
    with wallclock.span("mla.project"):
        h = L.norm(p["ln_attn"], x, kind=cfg.norm)
        q_nope, q_pe = L.linear(a["wq"], h).view(B, S, H, hd + rope).split(
            [hd, rope], -1)
        c_kv, k_pe = L.linear(a["wkv_a"], h).split([r, rope], -1)
        kv = L.linear(a["wkv_b"], L.norm(a["kv_norm"], c_kv, kind=cfg.norm))
        k_nope, v = kv.view(B, S, H, 2 * hd).split([hd, hd], -1)
        q = torch.cat([q_nope, apply_rope(q_pe, positions, cfg)], -1)
        k_pe = apply_rope(k_pe.reshape(B, S, 1, rope), positions, cfg)
        k = torch.cat([k_nope, k_pe.expand(B, S, H, rope)], -1)
    with wallclock.span("mla.attend"):
        o = attend(q, k, v, positions[0], positions[0], causal=True,
                   window=cfg.sliding_window, causal_skip=causal_skip,
                   scale=softmax_scale(cfg))
        return x + L.linear(a["wo"], o.reshape(B, S, H * hd))


# ------------------------------------------------------------------- MoE

def route(router: dict, h: torch.Tensor, cfg: MLAMoEConfig):
    """h (N, D) -> (weights (N, K) float32, experts (N, K), scores (N, E)
    float32): the greedy top-k of the softmax over the routed experts."""
    m = cfg.dsmoe
    scores = torch.softmax(h.float() @ router["w"].float(), dim=-1)
    w, idx = torch.topk(scores, m.top_k, dim=-1)
    if m.norm_topk_prob:
        w = w / w.sum(-1, keepdim=True).clamp(min=1e-20)
    else:
        w = w * m.routed_scaling_factor
    return w, idx, scores


def balance_loss(scores: torch.Tensor, idx: torch.Tensor, B: int,
                 cfg: MLAMoEConfig) -> torch.Tensor:
    """The sequence-wise balance loss of one layer: scores (B S, E), idx
    (B S, K) -> float32 scalar."""
    m = cfg.dsmoe
    E, K = m.n_routed_experts, m.top_k
    S = scores.shape[0] // B
    counts = torch.zeros(B, E, dtype=torch.float32, device=scores.device)
    counts.scatter_add_(1, idx.reshape(B, S * K),
                        torch.ones(B, S * K, device=scores.device))
    f = counts * (E / (S * K))
    P = scores.view(B, S, E).mean(1)
    return m.aux_loss_alpha * (f * P).sum(1).mean()


def expert_counts(idx: torch.Tensor, E: int) -> torch.Tensor:
    """Assignments an expert, int64 (E,), on the device (no host read)."""
    flat = idx.reshape(-1)
    return torch.zeros(E, dtype=torch.int64, device=idx.device).scatter_add_(
        0, flat, torch.ones_like(flat))


def _count_rows(counts: torch.Tensor, offs: torch.Tensor, rows: int) -> None:
    """The layer's counters, read on the host (one sync) only while a
    recorder is active, and only in the forward (a checkpointed layer's
    recompute in the backward routes the same rows again)."""
    if not wallclock.counting() or torch._C._current_graph_task_id() != -1:
        return
    busiest, covered = torch.stack([counts.max(), offs[-1].long()]).tolist()
    wallclock.count("moe.rows", rows)
    wallclock.count("moe.rows_max", busiest)
    wallclock.count("moe.dropped", rows - covered)


def experts_dropless(ex: dict, h: torch.Tensor, w: torch.Tensor,
                     idx: torch.Tensor, cfg: MLAMoEConfig) -> torch.Tensor:
    """Every assignment through its expert's SwiGLU, weighted and summed
    a token: h (N, D), w and idx (N, K) -> (N, D) float32."""
    N, D = h.shape
    K, E = idx.shape[1], cfg.dsmoe.n_routed_experts
    with wallclock.span("moe.dispatch"):
        flat = idx.reshape(-1)
        order = torch.argsort(flat, stable=True)
        counts = expert_counts(idx, E)
        offs = counts.cumsum(0).to(torch.int32)
        xs = h.index_select(0, order // K)
        _count_rows(counts, offs, N * K)
    with wallclock.span("moe.experts"):
        g = ops.grouped_mm_op(xs, ex["w_gate"], offs)
        u = ops.grouped_mm_op(xs, ex["w_up"], offs)
        out = ops.grouped_mm_op(F.silu(g) * u, ex["w_down"], offs)
    with wallclock.span("moe.combine"):
        inv = torch.empty_like(order).scatter_(
            0, order, torch.arange(order.numel(), device=order.device))
        y = out.index_select(0, inv).view(N, K, D).float()
        return (y * w[..., None]).sum(1)


def moe_ffn(p: dict, h: torch.Tensor, cfg: MLAMoEConfig):
    """DeepSeekMoE on h (B, S, D) -> (the routed experts' sum plus the
    shared experts', in h's dtype; the layer's balance loss)."""
    B, S, D = h.shape
    flat = h.reshape(B * S, D)
    with wallclock.span("moe.route"):
        w, idx, scores = route(p["router"], flat, cfg)
        aux = balance_loss(scores, idx, B, cfg)
    y = experts_dropless(p["experts"], flat, w, idx, cfg)
    with wallclock.span("moe.shared"):
        shared = L.mlp(p["shared"], h, activation=cfg.activation)
    return y.view(B, S, D).to(h.dtype) + shared, aux


# ------------------------------------------------------------ the layers

def dense_block(p: dict, x: torch.Tensor, positions: torch.Tensor,
                cfg: MLAMoEConfig, causal_skip: bool = False
                ) -> torch.Tensor:
    x = mla_residual(p, x, positions, cfg, causal_skip=causal_skip)
    return T.mlp_residual(p, x, cfg)


def moe_block(p: dict, x: torch.Tensor, positions: torch.Tensor,
              cfg: MLAMoEConfig, causal_skip: bool = False):
    """(x after the layer, the layer's balance loss)."""
    x = mla_residual(p, x, positions, cfg, causal_skip=causal_skip)
    y, aux = moe_ffn(p, L.norm(p["ln_mlp"], x, kind=cfg.norm), cfg)
    return x + y, aux


def _scan_with_aux(apply_fn, stacked: dict, x: torch.Tensor, *,
                   remat: str):
    """:func:`transformer.scan_blocks` for layers that also return a loss
    term: (x, the terms' sum)."""
    if remat not in T.REMAT:
        raise ValueError(remat)
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    per_layer = tree_map(lambda t: t.unbind(0), stacked)
    for i in range(len(tree_leaves(per_layer)[0])):
        p = tree_map(lambda u: u[i], per_layer)
        if remat == "none":
            x, aux = apply_fn(p, x)
        else:
            x, aux = checkpoint(apply_fn, p, x, use_reentrant=False,
                                **({"context_fn": T._save_dots}
                                   if remat == "dots" else {}))
        total = total + aux
    return x, total


def _whole(t):
    return t.full_tensor() if shd.is_dtensor(t) else t


def forward(params: dict, tokens: torch.Tensor, cfg: MLAMoEConfig, *,
            remat: str = "full", causal_skip: bool = False,
            aux: bool = False):
    """tokens (B, S) -> float32 logits (B, S, V), and with ``aux`` the
    balance loss summed over the MoE layers beside them."""
    params = tree_map(_whole, params)
    tokens = _whole(tokens)
    B, S = tokens.shape
    x = T._embed_input(params, tokens, cfg, None)
    positions = T.seq_positions(B, S, x.device)
    x = T.scan_blocks(lambda p, x: dense_block(p, x, positions, cfg,
                                               causal_skip),
                      params["dense"], x, remat=remat)
    x, bal = _scan_with_aux(lambda p, x: moe_block(p, x, positions, cfg,
                                                   causal_skip),
                            params["blocks"], x, remat=remat)
    logits = T._logits(params, x, cfg)
    return (logits, bal) if aux else logits


def init_cache(batch_size: int, cache_len: int, device):
    raise NotImplementedError("the latent-attention MoE family has no serve "
                              "path yet (no latent KV cache)")


def decode(params, cache, batch):
    raise NotImplementedError("the latent-attention MoE family has no serve "
                              "path yet (no latent KV cache)")
