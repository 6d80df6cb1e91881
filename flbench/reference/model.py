"""The paper's two CNNs and Elastic Model Shrinking, in plain PyTorch.

FedAvg's FMNIST CNN (two 5x5 convolutions of 32 and 64 channels, a dense
layer of 512) and VGG-9 for CIFAR-10 (six 3x3 convolutions of 64-128-256
channels, dense 512-512-10), in the port's layouts: NHWC images, HWIO
convolution weights, ``(in, out)`` linear weights, the features
flattened in (H, W, C) order.  Parameters are nested dicts walked in
sorted-key order.  Shrinking sorts each width group's channels by the L2
norm of the producing weight (stable, descending) and keeps the first
``ceil(size * sqrt(alpha))``.  Local training is plain SGD by autograd,
one client and one minibatch at a time.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

F32 = torch.float32


# ------------------------------------------------------------------ pytrees

def leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    return [tree]


def named(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in named(tree[k],
                                                       f"{prefix}{k}.")]
    return [(prefix[:-1], tree)]


def rebuild(template, items):
    it = iter(items)

    def go(node):
        if isinstance(node, dict):
            return {k: go(node[k]) for k in sorted(node)}
        return next(it)
    return go(template)


def tmap(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: tmap(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    return fn(tree, *rest)


def flat(tree) -> torch.Tensor:
    return torch.cat([x.reshape(-1).float() for x in leaves(tree)])


def unflat(template, vec):
    out, off = [], 0
    for x in leaves(template):
        out.append(vec[off:off + x.numel()].view(x.shape))
        off += x.numel()
    return rebuild(template, out)


# -------------------------------------------------------------------- model

def init_params(model: dict, seed: int, device) -> dict:
    """He-normal weights (std sqrt(2/fan_in) for convolutions, 1/sqrt(fan_in)
    for dense layers), zero biases, drawn in layer order from one CPU
    generator seeded with ``seed``."""
    gen = torch.Generator().manual_seed(seed)

    def normal(shape, scale):
        std = scale / math.sqrt(math.prod(shape[:-1]))
        return torch.randn(shape, generator=gen, dtype=F32) * std

    def conv(k, cin, cout):
        return {"w": normal((k, k, cin, cout), math.sqrt(2.0)),
                "b": torch.zeros(cout)}

    def dense(din, dout):
        return {"w": normal((din, dout), 1.0), "b": torch.zeros(dout)}

    c, d_ff, n_cls = model["d_model"], model["d_ff"], model["vocab_size"]
    if model["name"].startswith("fmnist"):
        p = {"conv1": conv(5, 1, c), "conv2": conv(5, c, 2 * c),
             "dense1": dense(7 * 7 * 2 * c, d_ff),
             "dense2": dense(d_ff, n_cls)}
    else:
        chans = [3, c, c, 2 * c, 2 * c, 4 * c, 4 * c]
        p = {f"conv{i}": conv(3, chans[i - 1], chans[i]) for i in range(1, 7)}
        p["dense1"] = dense(4 * 4 * 4 * c, d_ff)
        p["dense2"] = dense(d_ff, d_ff)
        p["dense3"] = dense(d_ff, n_cls)
    return tmap(lambda t: t.to(device), p)


def _conv(p, x):
    k = p["w"].shape[0]
    return F.conv2d(x, p["w"].permute(3, 2, 0, 1), p["b"], padding=k // 2)


def forward(params: dict, images: torch.Tensor) -> torch.Tensor:
    """NHWC images -> logits; widths are read from the parameters."""
    x = images.permute(0, 3, 1, 2)
    n_conv = sum(1 for k in params if k.startswith("conv"))
    for i in range(1, n_conv + 1):
        x = F.relu(_conv(params[f"conv{i}"], x))
        if n_conv == 2 or i % 2 == 0:
            x = F.max_pool2d(x, 2)
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
    dense = sorted(k for k in params if k.startswith("dense"))
    for j, name in enumerate(dense):
        x = x @ params[name]["w"] + params[name]["b"]
        if j < len(dense) - 1:
            x = F.relu(x)
    return x


def loss(params, images, labels) -> torch.Tensor:
    logp = F.log_softmax(forward(params, images).float(), dim=-1)
    return -logp.gather(-1, labels.long()[:, None]).mean()


def sgd(params: dict, images: torch.Tensor, labels: torch.Tensor, lr: float,
        fault: str | None = None, on_step=None) -> dict:
    """Plain SGD over stacked minibatches ``images: (steps, B, ...)``;
    ``on_step(s, p)`` sees the parameters each step starts from.  A
    planted ``fault``: ``frozen`` (each step returns its state unchanged)
    or ``half_batch`` (each step's loss over the first half of its
    minibatch)."""
    p = tmap(lambda t: t.detach().clone(), params)
    for s in range(images.shape[0]):
        if on_step is not None:
            on_step(s, p)
        if fault == "frozen":
            continue
        x, y = images[s], labels[s]
        if fault == "half_batch":
            x, y = x[: x.shape[0] // 2], y[: y.shape[0] // 2]
        lv = [t.requires_grad_() for t in leaves(p)]
        g = torch.autograd.grad(loss(rebuild(p, lv), x, y), lv)
        with torch.no_grad():
            p = rebuild(p, [a - lr * b for a, b in zip(lv, g)])
    return p


# -------------------------------------------------------------------- EMS

def width_groups(model: dict) -> list[tuple]:
    """(name, size, entries, sort_by) per width group; an entry is
    (path, axis, outer)."""
    c, d_ff = model["d_model"], model["d_ff"]
    if model["name"].startswith("fmnist"):
        return [
            ("conv1", c, [("conv1.w", 3, 1), ("conv1.b", 0, 1),
                          ("conv2.w", 2, 1)], ("conv1.w", 3, 1)),
            ("conv2", 2 * c, [("conv2.w", 3, 1), ("conv2.b", 0, 1),
                              ("dense1.w", 0, 49)], ("conv2.w", 3, 1)),
            ("dense1", d_ff, [("dense1.w", 1, 1), ("dense1.b", 0, 1),
                              ("dense2.w", 0, 1)], ("dense1.w", 1, 1)),
        ]
    chans = [c, c, 2 * c, 2 * c, 4 * c, 4 * c]
    groups = []
    for i in range(6):
        name = f"conv{i + 1}"
        nxt = (f"conv{i + 2}.w", 2, 1) if i < 5 else ("dense1.w", 0, 16)
        groups.append((name, chans[i], [(f"{name}.w", 3, 1),
                                        (f"{name}.b", 0, 1), nxt],
                       (f"{name}.w", 3, 1)))
    for j, nxt in ((1, "dense2.w"), (2, "dense3.w")):
        groups.append((f"dense{j}", d_ff,
                       [(f"dense{j}.w", 1, 1), (f"dense{j}.b", 0, 1),
                        (nxt, 0, 1)], (f"dense{j}.w", 1, 1)))
    return groups


def widths(model: dict, alpha: float) -> dict:
    m = math.sqrt(alpha)
    return {g[0]: min(max(int(math.ceil(g[1] * m)), 1), g[1])
            for g in width_groups(model)}


def _get(tree, path):
    for part in path.split("."):
        tree = tree[part]
    return tree


def _set(tree, path, value):
    parts = path.split(".")
    for part in parts[:-1]:
        tree = tree[part]
    tree[parts[-1]] = value


def _copy(tree):
    return {k: _copy(v) for k, v in tree.items()} \
        if isinstance(tree, dict) else tree


def _view(x, axis, outer, size):
    s = tuple(x.shape)
    return x.reshape(s[:axis] + (outer, size, s[axis] // (outer * size))
                     + s[axis + 1:])


def _unview(x, axis):
    s = tuple(x.shape)
    return x.reshape(s[:axis] + (s[axis] * s[axis + 1] * s[axis + 2],)
                     + s[axis + 3:])


def sort_channels(params: dict, model: dict) -> dict:
    """Server-side channel sorting (§III-B.1), function-preserving."""
    out = _copy(params)
    for _, size, entries, (path, axis, outer) in width_groups(model):
        v = _view(_get(out, path), axis, outer, size)
        dims = tuple(d for d in range(v.dim()) if d != axis + 1)
        perm = torch.argsort(-torch.sqrt(v.square().sum(dim=dims)),
                             stable=True)
        for p, ax, o in entries:
            x = _view(_get(out, p), ax, o, size)
            _set(out, p, _unview(x.index_select(ax + 1, perm), ax))
    return out


def shrink(params: dict, model: dict, alpha: float) -> dict:
    """The alpha sub-model of sorted parameters."""
    w = widths(model, alpha)
    out = _copy(params)
    for name, size, entries, _ in width_groups(model):
        for p, ax, o in entries:
            x = _view(_get(out, p), ax, o, size)
            _set(out, p, _unview(x.narrow(ax + 1, 0, w[name]), ax))
    return out


def expand(sub_update: dict, model: dict, alpha: float, full: dict):
    """Zero-pad a sub-model update to full width -> (update, width mask)."""
    w = widths(model, alpha)
    upd = _copy(full)
    mask = _copy(full)
    by_path = {}
    for name, size, entries, _ in width_groups(model):
        for p, ax, o in entries:
            by_path.setdefault(p, []).append((ax, o, size, w[name]))
    for path, _ in named(full):
        u = _get(sub_update, path)
        m = torch.ones_like(u)
        for ax, o, size, n in by_path.get(path, []):
            pieces = []
            for x in (u, m):
                v = _view(x, ax, o, n)
                shape = list(v.shape)
                shape[ax + 1] = size
                big = v.new_zeros(shape)
                big.narrow(ax + 1, 0, n).copy_(v)
                pieces.append(_unview(big, ax))
            u, m = pieces
        _set(upd, path, u)
        _set(mask, path, m)
    return upd, mask


def forward_flops(model: dict, alpha: float, n_samples: int) -> float:
    """Multiply-adds x 2 of the alpha sub-model's forward over
    ``n_samples`` images."""
    w = widths(model, alpha)
    if model["name"].startswith("fmnist"):
        c1, c2, d = w["conv1"], w["conv2"], w["dense1"]
        per = 2 * (28 * 28 * 25 * 1 * c1 + 14 * 14 * 25 * c1 * c2
                   + 49 * c2 * d + d * model["vocab_size"])
    else:
        ch = [3] + [w[f"conv{i}"] for i in range(1, 7)]
        hw = [32, 32, 16, 16, 8, 8]
        per = sum(2 * hw[i] ** 2 * 9 * ch[i] * ch[i + 1] for i in range(6))
        d1, d2 = w["dense1"], w["dense2"]
        per += 2 * (16 * ch[6] * d1 + d1 * d2 + d2 * model["vocab_size"])
    return float(per) * n_samples
