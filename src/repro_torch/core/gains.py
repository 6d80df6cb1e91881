"""Learning gains and convergence bounds (paper §IV-B/C).

Definition 3:  g_{t,i} = alpha^4 * beta   (local learning gain)
               g_t = mean_i g_{t,i}       (global learning gain)
Lemma 1:       E||delta||^2 <= (1 - a(2-a)sqrt(b))^2 E||u||^2
Theorem 2:     E(F(w_T) - F*) <= Z^{T-1} E(F(w_0) - F*),
               Z = 1 - (nu/lambda)(1 - eps(1 - g_min))

Float32 wherever the reference computes in float32.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.aggregation import divergence_factor

F32 = torch.float32


def local_gain(alpha, beta) -> torch.Tensor:
    """Definition 3: g = alpha^4 * beta, the power as two squarings (the
    rounding of the reference's integer power)."""
    a2 = torch.as_tensor(alpha, dtype=F32).square()
    return a2.square() * torch.as_tensor(beta, dtype=F32)


def global_gain(alphas, betas) -> torch.Tensor:
    return local_gain(alphas, betas).mean()


def local_divergence_bound(alpha, beta, u_sq_norm) -> torch.Tensor:
    """Lemma 1 upper bound on E||u - u~||^2."""
    return divergence_factor(alpha, beta).square() \
        * torch.as_tensor(u_sq_norm, dtype=F32)


def contraction_factor(g_min, *, nu: float, lam: float, eps: float
                       ) -> torch.Tensor:
    """Theorem 2's Z. Convergence requires Z < 1, i.e.
    eps (1 - g_min) < 1."""
    g_min = torch.as_tensor(g_min, dtype=F32)
    return 1.0 - (nu / lam) * (1.0 - eps * (1.0 - g_min))


def rounds_to_epsilon(target: float, f0_gap: float, g_min: float, *,
                      nu: float, lam: float, eps: float) -> float:
    """Rounds T with Z^{T-1} * f0_gap <= target (Theorem 2, solved for T)."""
    z = float(contraction_factor(g_min, nu=nu, lam=lam, eps=eps))
    if z >= 1.0:
        return float("inf")
    return 1.0 + math.log(target / f0_gap) / math.log(z)
