"""Flexible Gradient Compression (paper §III-C) in plain PyTorch.

Kernel-wise sparsification (Eq. 2: keep the ``ceil((1-rho)K)`` kernels of
largest L2 norm; a kernel is one output unit's fan-in slice, a 1-D leaf
is one kernel), probabilistic quantization on a uniform grid of L
intervals over the surviving magnitudes (Eq. 3-4) with pre-drawn
uniforms, and the coded-size model (empirical entropy of the levels plus
a sign bit, Golomb-coded mask, an 80-bit header).  The server's beta
planner sweeps (rho, L) on a probe update and interpolates the
divergence-minimizing pairs.  Every reduction is float32, as the
program's arithmetic is stated; the kept count is computed in float32.
"""
from __future__ import annotations

import math

import numpy as np
import torch

F32 = torch.float32
HEADER_BITS = 2 * 32 + 16
MAX_LEVELS = 65535
RHO_GRID = (0.0, 0.3, 0.5, 0.7, 0.8, 0.9, 0.95, 0.99)
LEVEL_GRID = (2, 4, 8, 16, 32, 64, 128, 256, 1024, 4096)


def kernel_shape(shape):
    if len(shape) >= 2:
        return shape[-1], math.prod(shape[:-1])
    return 1, math.prod(shape) if shape else 1


def kernel_views(vec, shapes):
    """Each leaf's segment of the flat vector as (K, ksize) rows."""
    out, off = [], 0
    for s in shapes:
        k, ks = kernel_shape(tuple(s))
        out.append(vec[off:off + k * ks].view(ks, k).t())
        off += k * ks
    return out


def kernel_norms(vec, shapes):
    return torch.cat([torch.sqrt(v.square().sum(1))
                      for v in kernel_views(vec, shapes)])


def threshold(norms, rho):
    K = norms.shape[0]
    kept = torch.ceil((1.0 - torch.clamp(torch.tensor(rho, dtype=F32),
                                         0.0, 1.0)) * K)
    idx = int(torch.clamp(K - kept, 0, K - 1))
    return torch.sort(norms).values[idx]


def element_mask(keep, shapes):
    parts, k0 = [], 0
    for s in shapes:
        k, ks = kernel_shape(tuple(s))
        parts.append(keep[k0:k0 + k, None].expand(k, ks).t().reshape(-1))
        k0 += k
    return torch.cat(parts)


def quantize(v, mask, n_levels, rand):
    """(dequantized values, int levels) of the masked elements."""
    L = torch.tensor(float(n_levels), dtype=F32, device=v.device)
    av = v.abs() * mask
    nz = mask > 0
    inf = torch.tensor(float("inf"), device=v.device)
    u_min = torch.where(nz & (av > 0), av, inf).min()
    u_min = torch.where(torch.isfinite(u_min), u_min, torch.zeros_like(u_min))
    u_max = torch.where(nz, av, -inf).max()
    u_max = torch.where(torch.isfinite(u_max), u_max, torch.zeros_like(u_max))
    step = torch.clamp(u_max - u_min, min=1e-20) / L
    t = torch.minimum(torch.clamp((av - u_min) / step, min=0.0), L)
    lo = torch.floor(t)
    lvl = torch.minimum(torch.clamp(lo + (rand < t - lo).to(F32), min=0.0), L)
    q = torch.where(nz, (u_min + lvl * step) * torch.sign(v),
                    torch.zeros((), device=v.device))
    return q, torch.where(nz, lvl, torch.zeros((), device=v.device)).long()


def coded_bits(levels, mask) -> torch.Tensor:
    mask = mask.to(F32)
    nnz = torch.clamp(mask.sum(), min=1.0)
    hist = torch.zeros(MAX_LEVELS + 1, dtype=F32, device=mask.device)
    hist.index_add_(0, levels, mask)
    p = hist / nnz
    terms = p * torch.log2(torch.clamp(p, min=1e-12))
    h = -torch.where(p > 0, terms, torch.zeros_like(terms)).sum()
    n, kept = mask.numel(), mask.sum()
    pk = torch.clamp(kept / n, 1e-9, 1 - 1e-9)
    b = torch.ceil(torch.log2(torch.clamp(-1.0 / torch.log2(1.0 - pk),
                                          min=1.0)))
    golomb = kept * (b + 1.0 / (1.0 - torch.pow(1.0 - pk, torch.exp2(b))))
    return nnz * (h + 1.0) + golomb + HEADER_BITS


def compress(vec, shapes, rho, n_levels, rand):
    """Eq. 2-4 and the size model over a flat update ->
    (values, element mask, bits)."""
    norms = kernel_norms(vec, shapes)
    mask = element_mask((norms >= threshold(norms, rho)).to(F32), shapes)
    q, lvl = quantize(vec, mask, n_levels, rand)
    return q, mask, coded_bits(lvl, mask)


class Planner:
    """The piecewise-linear beta -> (rho, L) map fit on a probe update."""

    def __init__(self, probe_vec, shapes, rand):
        norms = kernel_norms(probe_vec, shapes)
        n = probe_vec.numel()
        records = []
        for rho in RHO_GRID:
            keep = (norms >= threshold(norms, rho)).to(F32)
            mask = element_mask(keep, shapes)
            masked = probe_vec * mask
            for L in LEVEL_GRID:
                q, lvl = quantize(masked, mask, L, rand)
                beta = float(coded_bits(lvl, mask)) / (32.0 * n)
                err = float(torch.linalg.vector_norm(q * mask - probe_vec))
                records.append((beta, rho, L, err))
        records.sort()
        self.betas, self.rhos, self.levels = [], [], []
        best = np.inf
        for beta, rho, L, err in records:
            if err < best:
                best = err
                self.betas.append(beta)
                self.rhos.append(rho)
                self.levels.append(L)

    def plan(self, beta: float) -> tuple[float, int]:
        b = float(np.clip(beta, self.betas[0], self.betas[-1]))
        rho = float(np.interp(b, self.betas, self.rhos))
        lvl = int(round(float(np.interp(b, self.betas, self.levels))))
        return rho, max(lvl, 2)
