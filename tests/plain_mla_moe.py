"""A plain float32 PyTorch model of DeepSeek-V2's decoder, for the tests.

Written from the paper (arXiv:2405.04434) and the published modelling
code's equations, independent of the port (nothing of ``repro_torch``
is imported) and of the benchmark's row-by-row copy
(``flbench/reference/lm_mla_moe.py``), which the tests hold to this one.
The whole batch goes through autograd at once.  Parameters are a flat
``{dotted path: tensor}`` dict in the benchmark's layout (``dense.*``
and ``blocks.*`` stacked over the dense and the MoE layers); ``model``
is the benchmark configuration's ``model`` group.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _rms(x, scale, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * scale


def _yarn_m(factor, m):
    return 0.1 * m * math.log(factor) + 1.0 if factor > 1 else 1.0


def inv_freq(model: dict) -> torch.Tensor:
    dim, base, y = (model["qk_rope_head_dim"], model["rope_theta"],
                    model["rope_scaling"])
    orig = y["original_max_position_embeddings"]

    def corr(rot):
        return dim * math.log(orig / (rot * 2 * math.pi)) \
            / (2 * math.log(base))

    lo = max(math.floor(corr(y["beta_fast"])), 0)
    hi = min(math.ceil(corr(y["beta_slow"])), dim - 1)
    if lo == hi:
        hi += 0.001
    i = torch.arange(dim // 2, dtype=torch.float32)
    ramp = ((i - lo) / (hi - lo)).clamp(0, 1)
    base_f = base ** (-2 * i / dim)
    return base_f * (1 - ramp) + base_f / y["factor"] * ramp


def rope(x, model: dict):
    """x (B, S, h, d): de-interleave the pairs, then rotate the halves."""
    B, S, h, d = x.shape
    y = model["rope_scaling"]
    f = _yarn_m(y["factor"], y["mscale"]) / _yarn_m(y["factor"],
                                                     y["mscale_all_dim"])
    x = torch.cat([x[..., 0::2], x[..., 1::2]], -1)
    ang = torch.arange(S, dtype=torch.float32)[:, None] * inv_freq(model)
    cos = torch.cat([ang.cos(), ang.cos()], -1)[None, :, None] * f
    sin = torch.cat([ang.sin(), ang.sin()], -1)[None, :, None] * f
    rot = torch.cat([-x[..., d // 2:], x[..., :d // 2]], -1)
    return x * cos + rot * sin


def attn_scale(model: dict) -> float:
    y = model["rope_scaling"]
    m = _yarn_m(y["factor"], y["mscale_all_dim"])
    return m * m / math.sqrt(model["head_dim"] + model["qk_rope_head_dim"])


def mla(p, h, model, eps):
    B, S, _ = h.shape
    H, hd = model["n_heads"], model["head_dim"]
    r, dr = model["kv_lora_rank"], model["qk_rope_head_dim"]
    q = (h @ p["attn.wq.w"]).view(B, S, H, hd + dr)
    kva = h @ p["attn.wkv_a.w"]
    kv = (_rms(kva[..., :r], p["attn.kv_norm.scale"], eps)
          @ p["attn.wkv_b.w"]).view(B, S, H, 2 * hd)
    q = torch.cat([q[..., :hd], rope(q[..., hd:], model)], -1)
    kpe = rope(kva[..., r:][:, :, None, :], model).expand(B, S, H, dr)
    k = torch.cat([kv[..., :hd], kpe], -1)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * attn_scale(model)
    causal = torch.ones(S, S, dtype=torch.bool).tril()
    s = s.masked_fill(~causal, float("-inf")).softmax(-1)
    o = torch.einsum("bhqk,bkhd->bqhd", s, kv[..., hd:])
    return o.reshape(B, S, H * hd) @ p["attn.wo.w"]


def swiglu(h, g, u, d):
    return (F.silu(h @ g) * (h @ u)) @ d


def moe(p, h, model):
    """(the routed and shared experts' output, the layer's balance
    loss)."""
    B, S, D = h.shape
    E, K = model["n_routed_experts"], model["num_experts_per_tok"]
    x = h.reshape(B * S, D)
    scores = (x @ p["router.w"]).softmax(-1)
    w, idx = scores.topk(K, -1)
    w = w / w.sum(-1, keepdim=True) if model["norm_topk_prob"] \
        else w * model["routed_scaling_factor"]
    y = torch.zeros_like(x)
    for e in range(E):
        hit = (idx == e)
        rows = hit.any(-1).nonzero()[:, 0]
        if rows.numel():
            we = (w * hit).sum(-1)[rows, None]
            y = y.index_add(0, rows, we * swiglu(
                x[rows], p["experts.w_gate"][e], p["experts.w_up"][e],
                p["experts.w_down"][e]))
    y = y + swiglu(x, p["shared.w_gate"], p["shared.w_up"],
                   p["shared.w_down"])
    with torch.no_grad():
        onehot = F.one_hot(idx.view(B, S * K), E).float().sum(1)
        f = onehot * E / (S * K)
    P = scores.view(B, S, E).mean(1)
    aux = model["aux_loss_alpha"] * (f * P).sum(-1).mean()
    return y.view(B, S, D), aux


def forward(params: dict, tokens: torch.Tensor, model: dict,
            eps: float = 1e-6):
    """tokens (B, S) -> (logits (B, S, V), the balance losses' sum)."""
    x = params["embed.table"][tokens.long()]
    n_dense = model["first_k_dense_replace"]
    aux = torch.zeros(())
    for i in range(model["n_layers"]):
        moe_layer = i >= n_dense
        pre, j = ("blocks", i - n_dense) if moe_layer else ("dense", i)
        p = {k[len(pre) + 1:]: v[j] for k, v in params.items()
             if k.startswith(pre + ".")}
        x = x + mla(p, _rms(x, p["ln_attn.scale"], eps), model, eps)
        h = _rms(x, p["ln_mlp.scale"], eps)
        if moe_layer:
            y, a = moe(p, h, model)
            aux = aux + a
        else:
            y = swiglu(h, p["mlp.w_gate"], p["mlp.w_up"], p["mlp.w_down"])
        x = x + y
    x = _rms(x, params["ln_f.scale"], eps)
    return x @ params["unembed.w"], aux


def loss(params: dict, tokens: torch.Tensor, model: dict,
         eps: float = 1e-6) -> torch.Tensor:
    logits, aux = forward(params, tokens, model, eps)
    V = logits.shape[-1]
    return F.cross_entropy(logits[:, :-1].reshape(-1, V),
                           tokens[:, 1:].reshape(-1).long()) + aux
