import numpy as np
import torch


def draws(n, seed):
    gen = torch.Generator().manual_seed(seed)
    a = torch.rand(n, generator=gen)
    b = torch.randn(n, generator=gen)
    c = torch.empty(n).normal_(generator=gen)
    rng = np.random.default_rng([seed, 1])
    return a, b, c, rng.random(n)
