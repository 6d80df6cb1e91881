"""The latent-attention MoE decoder (DeepSeek-V2's family) in plain float32
PyTorch: its parameter layout, its forward pass and its loss, with the
gradients worked out layer by layer and row by row so that a model of
billions of parameters fits beside its optimizer state.

The equations (arXiv:2405.04434; DeepSeek-V2-Lite's published
modelling code, recalled): a layer is ``x + attn(rmsnorm(x))`` then
``x + ffn(rmsnorm(x))``.

* Attention (MLA, no query compression): ``q = h Wq``, each head's
  ``head_dim`` non-rotary then ``qk_rope_head_dim`` rotary columns;
  ``[c, k_pe] = h Wkv_a`` (``kv_lora_rank`` then ``qk_rope_head_dim``
  columns, ``k_pe`` one head for all); ``[k_nope, v] = rmsnorm(c) Wkv_b``
  per head (``head_dim`` each); RoPE on ``q_pe`` and ``k_pe`` with their
  pairs ``(2i, 2i+1)`` first taken apart into two halves, then rotated
  half against half, at YaRN's frequencies (``rope_scaling``: the
  pair's ``theta ** (-2i / rope)`` kept below the ramp from
  ``floor(d(beta_fast))`` to ``ceil(d(beta_slow))``, divided by
  ``factor`` above it, linear across it, where ``d(b) = rope * ln(orig /
  (2 pi b)) / (2 ln theta)``; cos and sin times ``m(mscale) /
  m(mscale_all_dim)``, ``m(s) = 0.1 s ln(factor) + 1``); causal softmax
  over ``q . [k_nope, k_pe]`` times ``(head_dim + rope) ** -0.5 *
  m(mscale_all_dim) ** 2``; ``o Wo``.
* FFN: the first ``first_k_dense_replace`` layers a SwiGLU MLP of
  ``d_ff``; the others DeepSeekMoE: ``scores = softmax(h Wr)`` over the
  ``n_routed_experts``, the ``num_experts_per_tok`` largest kept with
  their scores as weights (times ``routed_scaling_factor``; renormalised
  only under ``norm_topk_prob``), each token through each chosen
  expert's SwiGLU of ``moe_intermediate_size`` (every assignment, none
  dropped), weighted and summed, plus the shared experts' SwiGLU of
  ``n_shared_experts * moe_intermediate_size`` on every token.
* Loss: the mean next-token cross entropy plus, for each MoE layer, the
  sequence-wise balance loss ``aux_loss_alpha * mean_b sum_i f_bi
  P_bi``: ``f_bi`` row ``b``'s assignments to expert ``i`` times ``E /
  (S K)`` (a count, no gradient), ``P_bi`` the row's mean of the
  expert's score.
* A final RMSNorm and an untied unembedding.

Weights are stored ``(in, out)`` (an expert's ``(E, in, out)``) and
stacked over the layers, the dense ones under ``dense.``, the MoE ones
under ``blocks.``, one dotted path a leaf.  Everything computes in
float32 from the stored weights; every product with a weight, the
router's and the experts' among them, goes through ``mm`` so that the
control can put a lower precision in its place (``reference/pod.py``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

#: the stacked leaves of a layer's attention half and norms
ATTN = ("ln_attn.scale", "attn.wq.w", "attn.wkv_a.w", "attn.kv_norm.scale",
        "attn.wkv_b.w", "attn.wo.w", "ln_mlp.scale")
#: a dense layer's leaves, under ``dense.``
DENSE = ATTN + ("mlp.w_gate", "mlp.w_up", "mlp.w_down")
#: a MoE layer's leaves, under ``blocks.``
MOE = ATTN + ("router.w", "experts.w_gate", "experts.w_up",
              "experts.w_down", "shared.w_gate", "shared.w_up",
              "shared.w_down")


def _sizes(m: dict) -> dict:
    d, H, hd = m["d_model"], m["n_heads"], m["head_dim"]
    r, rope = m["kv_lora_rank"], m["qk_rope_head_dim"]
    E, f = m["n_routed_experts"], m["moe_intermediate_size"]
    fs = m["n_shared_experts"] * f
    return {"ln_attn.scale": (d,), "attn.wq.w": (d, H * (hd + rope)),
            "attn.wkv_a.w": (d, r + rope), "attn.kv_norm.scale": (r,),
            "attn.wkv_b.w": (r, H * 2 * hd), "attn.wo.w": (H * hd, d),
            "ln_mlp.scale": (d,), "mlp.w_gate": (d, m["d_ff"]),
            "mlp.w_up": (d, m["d_ff"]), "mlp.w_down": (m["d_ff"], d),
            "router.w": (d, E), "experts.w_gate": (E, d, f),
            "experts.w_up": (E, d, f), "experts.w_down": (E, f, d),
            "shared.w_gate": (d, fs), "shared.w_up": (d, fs),
            "shared.w_down": (fs, d)}


def leaves(model: dict) -> list[tuple[str, tuple, object]]:
    """(path, shape, init) of every leaf, a layer's stacked over the dense
    or the MoE layers; a matrix starts normal with the standard deviation
    ``1/sqrt(fan_in)`` (an expert's own fan-in), the embedding ``0.02``,
    the norms' scales at ones."""
    if model.get("tie_embeddings"):
        raise ValueError("the reference has an untied unembedding")
    if model["n_kv_heads"] != model["n_heads"]:
        raise ValueError("latent attention has a key and value per head")
    n_dense = model["first_k_dense_replace"]
    n_moe = model["n_layers"] - n_dense
    if n_dense < 1 or n_moe < 1:
        raise ValueError("the reference stacks one dense layer or more and "
                         "one MoE layer or more")
    shapes = _sizes(model)
    d, V = model["d_model"], model["vocab_size"]
    out = [("embed.table", (V, d), ("normal", 0.02))]
    for prefix, names, n in (("dense", DENSE, n_dense),
                             ("blocks", MOE, n_moe)):
        for k in names:
            s = shapes[k]
            init = "ones" if len(s) == 1 else ("normal",
                                               1.0 / math.sqrt(s[-2]))
            out.append((f"{prefix}.{k}", (n,) + s, init))
    out += [("ln_f.scale", (d,), "ones"),
            ("unembed.w", (d, V), ("normal", 1.0 / math.sqrt(d)))]
    return out


def stacked(path: str) -> bool:
    return path.startswith(("blocks.", "dense."))


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return x @ w


def rmsnorm(x, scale, eps: float):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def _mscale(factor: float, m: float) -> float:
    return 1.0 if factor <= 1 else 0.1 * m * math.log(factor) + 1.0


def rope_freqs(model: dict, device=None) -> torch.Tensor:
    """YaRN's frequencies of the rotary pairs, (rope / 2,)."""
    dim, base = model["qk_rope_head_dim"], model["rope_theta"]
    y = model["rope_scaling"]
    pair = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    extra = 1.0 / base ** pair
    inter = extra / y["factor"]

    def d_of(b):
        return dim * math.log(y["original_max_position_embeddings"]
                              / (b * 2 * math.pi)) / (2 * math.log(base))

    low = max(math.floor(d_of(y["beta_fast"])), 0)
    high = min(math.ceil(d_of(y["beta_slow"])), dim - 1)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(dim // 2, dtype=torch.float32, device=device)
             - low) / (high - low)).clamp(0, 1)
    return inter * ramp + extra * (1.0 - ramp)


def softmax_scale(model: dict) -> float:
    y = model["rope_scaling"]
    m = _mscale(y["factor"], y["mscale_all_dim"])
    return (model["head_dim"] + model["qk_rope_head_dim"]) ** -0.5 * m * m


def _rope(x, positions, model: dict):
    """x (B, S, h, rope): pairs taken apart, then the half rotation."""
    B, S, h, dr = x.shape
    x = x.reshape(B, S, h, dr // 2, 2).transpose(-1, -2).reshape(B, S, h, dr)
    y = model["rope_scaling"]
    f = _mscale(y["factor"], y["mscale"]) / _mscale(y["factor"],
                                                     y["mscale_all_dim"])
    ang = positions[:, None].float() * rope_freqs(model, x.device)
    cos, sin = torch.cos(ang)[:, None, :] * f, torch.sin(ang)[:, None, :] * f
    x1, x2 = x[..., :dr // 2], x[..., dr // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def _swiglu(h, wg, wu, wd, mm):
    return mm(F.silu(mm(h, wg)) * mm(h, wu), wd)


def attention(p: dict, h: torch.Tensor, cfg: dict, mm) -> torch.Tensor:
    m = cfg["model"]
    B, S, _ = h.shape
    H, hd = m["n_heads"], m["head_dim"]
    r, rope = m["kv_lora_rank"], m["qk_rope_head_dim"]
    pos = torch.arange(S, device=h.device)
    q = mm(h, p["attn.wq.w"]).view(B, S, H, hd + rope)
    q = torch.cat([q[..., :hd], _rope(q[..., hd:], pos, m)], -1)
    kv_a = mm(h, p["attn.wkv_a.w"])
    c = rmsnorm(kv_a[..., :r], p["attn.kv_norm.scale"], cfg["rms_norm_eps"])
    k_pe = _rope(kv_a[..., r:].reshape(B, S, 1, rope), pos, m)
    kv = mm(c, p["attn.wkv_b.w"]).view(B, S, H, 2 * hd)
    k = torch.cat([kv[..., :hd], k_pe.expand(B, S, H, rope)], -1)
    v = kv[..., hd:]
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * softmax_scale(m)
    allowed = torch.ones(S, S, dtype=torch.bool, device=h.device).tril()
    window = cfg.get("sliding_window")
    if window is not None:
        allowed &= torch.ones_like(allowed).triu(1 - window)
    scores = scores.masked_fill(~allowed, float("-inf"))
    o = torch.einsum("bhqk,bkhd->bqhd", scores.softmax(-1), v)
    return mm(o.reshape(B, S, H * hd), p["attn.wo.w"])


def moe(p: dict, h: torch.Tensor, cfg: dict, mm):
    """DeepSeekMoE on one row h (1, S, d) -> (its output, the row's
    balance loss)."""
    m = cfg["model"]
    E, K = m["n_routed_experts"], m["num_experts_per_tok"]
    x = h[0]
    S = x.shape[0]
    scores = mm(x, p["router.w"]).softmax(-1)
    w, idx = scores.topk(K, -1)
    if m["norm_topk_prob"]:
        w = w / w.sum(-1, keepdim=True)
    else:
        w = w * m["routed_scaling_factor"]
    out = torch.zeros_like(x)
    for e in range(E):
        tok, slot = (idx == e).nonzero(as_tuple=True)
        if tok.numel() == 0:
            continue
        y = _swiglu(x[tok], p["experts.w_gate"][e], p["experts.w_up"][e],
                    p["experts.w_down"][e], mm)
        out = out.index_add(0, tok, y * w[tok, slot, None])
    out = out + _swiglu(x, p["shared.w_gate"], p["shared.w_up"],
                        p["shared.w_down"], mm)
    with torch.no_grad():
        f = torch.zeros(E, device=x.device).index_add_(
            0, idx.reshape(-1), torch.ones(S * K, device=x.device))
        f = f * E / (S * K)
    aux = m["aux_loss_alpha"] * (f * scores.mean(0)).sum()
    return out[None], aux


def block(p: dict, x: torch.Tensor, cfg: dict, moe_layer: bool,
          mm=matmul):
    """One layer on one row x (1, S, d) -> (the layer's output, the row's
    balance loss, 0 for a dense layer)."""
    eps = cfg["rms_norm_eps"]
    x = x + attention(p, rmsnorm(x, p["ln_attn.scale"], eps), cfg, mm)
    h = rmsnorm(x, p["ln_mlp.scale"], eps)
    if not moe_layer:
        return x + _swiglu(h, p["mlp.w_gate"], p["mlp.w_up"],
                           p["mlp.w_down"], mm), x.new_zeros(())
    y, aux = moe(p, h, cfg, mm)
    return x + y, aux


def _layers(cfg: dict):
    """(prefix, leaf names, index in the stack, MoE?) of each layer in
    order."""
    n_dense = cfg["model"]["first_k_dense_replace"]
    return [("dense", DENSE, i, False) for i in range(n_dense)] + \
        [("blocks", MOE, i, True)
         for i in range(cfg["model"]["n_layers"] - n_dense)]


def loss_and_grads(params: dict, tokens: torch.Tensor, cfg: dict,
                   mm=matmul) -> tuple[float, dict]:
    """(mean next-token cross entropy plus the balance losses, {path:
    float32 gradient}) of the stored weights ``params`` on ``tokens``
    ``(B, S)``.  The forward keeps each layer's input; the backward
    recomputes one layer of one row at a time from it, and the head one
    row at a time."""
    B, S = tokens.shape
    layers = _layers(cfg)
    table = params["embed.table"].float()
    x = table[tokens.long()]
    inputs, aux_total = [], 0.0
    with torch.no_grad():
        for prefix, names, i, is_moe in layers:
            inputs.append(x)
            p = {k: params[f"{prefix}.{k}"][i].float() for k in names}
            outs = [block(p, x[b:b + 1], cfg, is_moe, mm) for b in range(B)]
            x = torch.cat([o[0] for o in outs])
            aux_total += sum(float(o[1]) for o in outs) / B
            del p, outs
    head = {k: params[k].float().requires_grad_()
            for k in ("ln_f.scale", "unembed.w")}
    grads = {k: torch.zeros_like(v) for k, v in head.items()}
    gx = torch.zeros_like(x)
    n_tok, ce = B * (S - 1), 0.0
    for b in range(B):
        xb = x[b:b + 1].detach().requires_grad_()
        h = rmsnorm(xb, head["ln_f.scale"], cfg["rms_norm_eps"])
        logits = mm(h, head["unembed.w"])
        loss = F.cross_entropy(logits[0, :-1], tokens[b, 1:].long(),
                               reduction="sum") / n_tok
        gxb, *gh = torch.autograd.grad(loss, [xb] + list(head.values()))
        ce += float(loss.detach())
        gx[b:b + 1] = gxb
        for k, g in zip(head, gh):
            grads[k] += g
        del logits, h, loss, gh
    for prefix, names, _, _ in layers:
        for k in names:
            grads[f"{prefix}.{k}"] = torch.zeros(
                params[f"{prefix}.{k}"].shape, dtype=torch.float32,
                device=x.device)
    aux_weight = torch.tensor(1.0 / B, device=x.device)
    for prefix, names, i, is_moe in reversed(layers):
        xs = inputs.pop()
        p = {k: params[f"{prefix}.{k}"][i].float().requires_grad_()
             for k in names}
        for b in range(B):
            xi = xs[b:b + 1].detach().requires_grad_()
            y, aux = block(p, xi, cfg, is_moe, mm)
            outs, gouts = [y], [gx[b:b + 1]]
            if is_moe:
                outs.append(aux)
                gouts.append(aux_weight)
            gxi, *gp = torch.autograd.grad(outs, [xi] + list(p.values()),
                                           gouts, allow_unused=True)
            gx[b:b + 1] = gxi
            for k, g in zip(p, gp):
                if g is not None:
                    grads[f"{prefix}.{k}"][i] += g
            del y, xi, gp, gxi
        del xs, p
    gt = torch.zeros_like(table)
    gt.index_add_(0, tokens.reshape(-1).long(),
                  gx.reshape(-1, table.shape[1]))
    grads["embed.table"] = gt
    return ce + aux_total, grads
