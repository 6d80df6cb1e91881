"""The dense decoder (phi-3-mini's family) in plain float32 PyTorch: its
parameter layout, its forward pass and its next-token loss, with the
gradients worked out layer by layer so that a model of billions of
parameters fits beside its optimizer state.

The layer equations (arXiv:2404.14219, the Llama-2 block it follows):
``x + Wo attn(rope(Wq h), rope(Wk h), Wv h)`` with ``h = rmsnorm(x)``,
causal softmax attention scaled by ``1/sqrt(head_dim)``, grouped key and
value heads where there are fewer of them; then ``x + Wdown(silu(Wgate
h) * (Wup h))`` with ``h = rmsnorm(x)``; a final RMSNorm and an untied
unembedding; RoPE rotates the two halves of each head (not interleaved)
at frequencies ``theta ** (-i / (head_dim / 2))``.  Weights are stored
``(in, out)`` and stacked over the layers under ``blocks.``, one dotted
path a leaf.  Everything here computes in float32 from the stored
weights; the products go through ``mm`` so that the control can put a
lower precision in their place (``reference/pod.py``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

#: the stacked leaves of one block, under ``blocks.``
BLOCK = ("ln_attn.scale", "attn.wq.w", "attn.wk.w", "attn.wv.w",
         "attn.wo.w", "ln_mlp.scale", "mlp.w_gate", "mlp.w_up",
         "mlp.w_down")


def leaves(model: dict) -> list[tuple[str, tuple, object]]:
    """(path, shape, init) of every leaf, the block's stacked over the
    layers; matrices start normal with the standard deviation
    ``1/sqrt(fan_in)``, the embedding ``0.02``, the norms' scales at
    ones."""
    if model.get("tie_embeddings"):
        raise ValueError("the dense reference has an untied unembedding")
    L, d, ff, V = (model[k] for k in ("n_layers", "d_model", "d_ff",
                                      "vocab_size"))
    hq = model["n_heads"] * model["head_dim"]
    hkv = model["n_kv_heads"] * model["head_dim"]
    shapes = {"ln_attn.scale": (d,), "attn.wq.w": (d, hq),
              "attn.wk.w": (d, hkv), "attn.wv.w": (d, hkv),
              "attn.wo.w": (hq, d), "ln_mlp.scale": (d,),
              "mlp.w_gate": (d, ff), "mlp.w_up": (d, ff),
              "mlp.w_down": (ff, d)}
    out = [("embed.table", (V, d), ("normal", 0.02))]
    for k in BLOCK:
        s = shapes[k]
        init = "ones" if len(s) == 1 else ("normal", 1.0 / math.sqrt(s[0]))
        out.append((f"blocks.{k}", (L,) + s, init))
    out += [("ln_f.scale", (d,), "ones"),
            ("unembed.w", (d, V), ("normal", 1.0 / math.sqrt(d)))]
    return out


def stacked(path: str) -> bool:
    return path.startswith("blocks.")


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return x @ w


def rmsnorm(x, scale, eps: float):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def _rope(x, positions, theta: float):
    half = x.shape[-1] // 2
    freqs = 1.0 / theta ** (torch.arange(half, dtype=torch.float32,
                                         device=x.device) / half)
    ang = positions[:, None].float() * freqs                  # (S, half)
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def block(p: dict, x: torch.Tensor, cfg: dict, mm=matmul) -> torch.Tensor:
    """One decoder layer; ``p`` maps the :data:`BLOCK` names to float32
    weights."""
    m, eps = cfg["model"], cfg["rms_norm_eps"]
    B, S, _ = x.shape
    H, Hkv, hd = m["n_heads"], m["n_kv_heads"], m["head_dim"]
    pos = torch.arange(S, device=x.device)
    h = rmsnorm(x, p["ln_attn.scale"], eps)
    q = _rope(mm(h, p["attn.wq.w"]).view(B, S, H, hd), pos, m["rope_theta"])
    k = _rope(mm(h, p["attn.wk.w"]).view(B, S, Hkv, hd), pos,
              m["rope_theta"])
    v = mm(h, p["attn.wv.w"]).view(B, S, Hkv, hd)
    k = k.repeat_interleave(H // Hkv, dim=2)
    v = v.repeat_interleave(H // Hkv, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
    window = cfg.get("sliding_window")
    allowed = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    if window is not None:
        allowed &= torch.ones_like(allowed).triu(1 - window)
    scores = scores.masked_fill(~allowed, float("-inf"))
    o = torch.einsum("bhqk,bkhd->bqhd", scores.softmax(-1), v)
    x = x + mm(o.reshape(B, S, H * hd), p["attn.wo.w"])
    h = rmsnorm(x, p["ln_mlp.scale"], eps)
    gate = F.silu(mm(h, p["mlp.w_gate"]))
    return x + mm(gate * mm(h, p["mlp.w_up"]), p["mlp.w_down"])


def _rows(p: dict, x: torch.Tensor, cfg: dict, mm) -> torch.Tensor:
    """:func:`block` of each row of ``x`` apart (one row's attention
    scores alive at once)."""
    return torch.cat([block(p, x[b:b + 1], cfg, mm)
                      for b in range(x.shape[0])])


def loss_and_grads(params: dict, tokens: torch.Tensor, cfg: dict,
                   mm=matmul) -> tuple[float, dict]:
    """(mean next-token cross entropy, {path: float32 gradient}) of the
    stored weights ``params`` on ``tokens`` ``(B, S)``.  The forward keeps
    each layer's input; the backward recomputes one layer of one row at
    a time from it, so one row's activations of one layer are alive at
    once."""
    L = cfg["model"]["n_layers"]
    f32 = {k: v for k, v in params.items() if not stacked(k)}
    table = f32["embed.table"].float()
    x = table[tokens.long()]
    inputs = []
    with torch.no_grad():
        for i in range(L):
            inputs.append(x)
            x = _rows({k: params[f"blocks.{k}"][i].float() for k in BLOCK},
                      x, cfg, mm)
    x.requires_grad_()
    head = {k: f32[k].float().requires_grad_()
            for k in ("ln_f.scale", "unembed.w")}
    h = rmsnorm(x, head["ln_f.scale"], cfg["rms_norm_eps"])
    logits = mm(h, head["unembed.w"])
    V = logits.shape[-1]
    loss = F.cross_entropy(logits[:, :-1].reshape(-1, V),
                           tokens[:, 1:].reshape(-1).long())
    gx, *gh = torch.autograd.grad(loss, [x] + list(head.values()))
    del logits, h
    grads = dict(zip(head, gh))
    for k in BLOCK:
        grads[f"blocks.{k}"] = torch.zeros(
            params[f"blocks.{k}"].shape, dtype=torch.float32,
            device=x.device)
    for i in reversed(range(L)):
        xs = inputs.pop()
        p = {k: params[f"blocks.{k}"][i].float().requires_grad_()
             for k in BLOCK}
        for b in range(xs.shape[0]):
            xi = xs[b:b + 1].detach().requires_grad_()
            y = block(p, xi, cfg, mm)
            gxi, *gp = torch.autograd.grad(y, [xi] + list(p.values()),
                                           gx[b:b + 1])
            gx[b:b + 1] = gxi
            for k, g in zip(p, gp):
                grads[f"blocks.{k}"][i] += g
            del y, xi, gp, gxi
        del xs, p
    gt = torch.zeros_like(table)
    gt.index_add_(0, tokens.reshape(-1).long(),
                  gx.reshape(-1, table.shape[1]))
    grads["embed.table"] = gt
    return float(loss.detach()), grads
