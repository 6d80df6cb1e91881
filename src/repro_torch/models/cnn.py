"""The paper's own experiment models: FedAvg 2-conv CNN (FMNIST) and VGG-9
(CIFAR-10).

Layouts are the reference's at every public function: NHWC images, conv
weights HWIO ``(kh, kw, c_in, c_out)``, linear weights ``(in, out)``, and
the conv features flattened in (H, W, C) order before ``dense1`` (EMS
addresses ``dense1.w`` axis 0 as ``(outer=H*W, channels, 1)``).  Inside,
activations run as NCHW views and weights are transposed to OIHW only
at the ``F.conv2d`` call.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L


def init_conv(gen: torch.Generator, kh: int, kw: int, c_in: int,
              c_out: int, dtype: torch.dtype = torch.float32) -> dict:
    return {
        "w": L.param(gen, (kh, kw, c_in, c_out), (None, None, "fsdp", "tp"),
                     "normal", scale=math.sqrt(2.0), dtype=dtype),
        "b": L.param(gen, (c_out,), ("tp",), "zeros", dtype=dtype),
    }


def _conv_pads(padding, size: tuple, kernel: tuple, stride: int) -> tuple:
    """``((lo, hi), (lo, hi))`` over (H, W), as ``lax.conv_general_dilated``
    reads ``padding``: "SAME" (output ``ceil(n / stride)``, the odd pad
    on the high side), "VALID", or explicit pairs."""
    if not isinstance(padding, str):
        return tuple((int(lo), int(hi)) for lo, hi in padding)
    if padding == "VALID":
        return ((0, 0), (0, 0))
    if padding != "SAME":
        raise ValueError(f"unknown padding {padding!r}; expected 'SAME', "
                         "'VALID' or ((lo, hi), (lo, hi))")
    pads = []
    for n, k in zip(size, kernel):
        total = max((-(-n // stride) - 1) * stride + k - n, 0)
        pads.append((total // 2, total - total // 2))
    return tuple(pads)


def conv2d(p: dict, x: torch.Tensor, *, stride: int = 1,
           padding="SAME") -> torch.Tensor:
    """x: (B, C, H, W) view; w: HWIO.  ``padding`` as :func:`_conv_pads`;
    a symmetric pad goes to ``F.conv2d``, an asymmetric one through
    ``F.pad`` first (``F.conv2d``'s "same" refuses a stride above 1)."""
    w = p["w"].to(x.dtype)
    (top, bottom), (left, right) = _conv_pads(
        padding, tuple(x.shape[2:]), tuple(w.shape[:2]), stride)
    if top == bottom >= 0 and left == right >= 0:
        pad = (top, left)
    else:
        x = F.pad(x, (left, right, top, bottom))
        pad = 0
    return F.conv2d(x, w.permute(3, 2, 0, 1), p["b"].to(x.dtype),
                    stride=stride, padding=pad)


def _flatten_hwc(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, H*W*C), the reference's NHWC flatten order."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


# ------------------------------------------------------------- FMNIST CNN

def init_fmnist_cnn(gen: torch.Generator, cfg: ArchConfig) -> dict:
    c = cfg.d_model  # 32
    return {
        "conv1": init_conv(gen, 5, 5, 1, c),
        "conv2": init_conv(gen, 5, 5, c, 2 * c),
        "dense1": L.init_linear(gen, 7 * 7 * 2 * c, cfg.d_ff, bias=True,
                                axes=("fsdp", "tp")),
        "dense2": L.init_linear(gen, cfg.d_ff, cfg.vocab_size, bias=True,
                                axes=("tp", "classes")),
    }


def apply_fmnist_cnn(params: dict, images: torch.Tensor) -> torch.Tensor:
    """images: (B, 28, 28, 1) NHWC -> logits (B, 10)."""
    x = images.permute(0, 3, 1, 2)
    x = F.max_pool2d(F.relu(conv2d(params["conv1"], x)), 2)
    x = F.max_pool2d(F.relu(conv2d(params["conv2"], x)), 2)
    x = F.relu(L.linear(params["dense1"], _flatten_hwc(x)))
    return L.linear(params["dense2"], x)


# ----------------------------------------------------------------- VGG-9

def init_vgg9(gen: torch.Generator, cfg: ArchConfig) -> dict:
    c = cfg.d_model  # 64
    return {
        "conv1": init_conv(gen, 3, 3, 3, c),
        "conv2": init_conv(gen, 3, 3, c, c),
        "conv3": init_conv(gen, 3, 3, c, 2 * c),
        "conv4": init_conv(gen, 3, 3, 2 * c, 2 * c),
        "conv5": init_conv(gen, 3, 3, 2 * c, 4 * c),
        "conv6": init_conv(gen, 3, 3, 4 * c, 4 * c),
        "dense1": L.init_linear(gen, 4 * 4 * 4 * c, cfg.d_ff, bias=True,
                                axes=("fsdp", "tp")),
        "dense2": L.init_linear(gen, cfg.d_ff, cfg.d_ff, bias=True,
                                axes=("fsdp", "tp")),
        "dense3": L.init_linear(gen, cfg.d_ff, cfg.vocab_size, bias=True,
                                axes=("tp", "classes")),
    }


def apply_vgg9(params: dict, images: torch.Tensor) -> torch.Tensor:
    """images: (B, 32, 32, 3) NHWC -> logits (B, 10)."""
    x = images.permute(0, 3, 1, 2)
    for i in range(1, 7):
        x = F.relu(conv2d(params[f"conv{i}"], x))
        if i % 2 == 0:
            x = F.max_pool2d(x, 2)
    x = F.relu(L.linear(params["dense1"], _flatten_hwc(x)))
    x = F.relu(L.linear(params["dense2"], x))
    return L.linear(params["dense3"], x)


def init_cnn(gen: torch.Generator, cfg: ArchConfig) -> dict:
    if cfg.name.startswith("fmnist"):
        return init_fmnist_cnn(gen, cfg)
    return init_vgg9(gen, cfg)


def apply_cnn(params: dict, images: torch.Tensor) -> torch.Tensor:
    if "conv3" in params:
        return apply_vgg9(params, images)
    return apply_fmnist_cnn(params, images)


def image_shape(cfg: ArchConfig) -> tuple:
    return (28, 28, 1) if cfg.name.startswith("fmnist") else (32, 32, 3)
