"""Device selection for the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The device a run computes on; ``cuda`` unless the caller asks for
    the CPU.

    A CUDA request on a machine without a card raises instead of running
    on the CPU.  On the card, TF32 is switched off for matrix products
    and convolutions: cuDNN runs float32 convolutions in TF32 by default,
    which keeps about three decimal digits and would move the training
    numerics away from the float32 reference.  Reduced-precision
    reductions in bfloat16 products are switched off too: cuBLAS may
    otherwise add split-K partial sums in bfloat16, where XLA, and so the
    reference's bf16 LMs, accumulate every product in float32 and round
    once.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' (or "
                "--device cpu) to run on the CPU")
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction \
            = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}; expected 'cuda' "
                         f"or 'cpu'")
    return dev
