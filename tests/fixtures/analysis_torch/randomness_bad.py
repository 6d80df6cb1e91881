import random
import time

import numpy as np
import torch
from torch import randn


def draws(n):
    a = torch.rand(n)
    b = randn(n)
    c = torch.empty(n).normal_()
    d = torch.randint(0, 10, (n,))
    torch.manual_seed(0)
    torch.cuda.manual_seed_all(0)
    e = np.random.rand(n)
    f = random.random()
    return a, b, c, d, e, f, time.time()
