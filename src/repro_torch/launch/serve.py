"""Batched serving entry point: prefill, then token-by-token greedy decode.

Also the anycost serving story of the paper's Fig. 5d: ``--alpha`` serves
a width-shrunk sub-model cut from the same weights without retraining
(EMS channel sort, then shrink).  Weights are random, from ``--seed``.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-7b \\
      [--device cpu] [--full] --batch 2 --prompt-len 32 \\
      --decode-tokens 16 --alpha 0.5

Every LM arch serves: the attention families (dense, moe, vlm) prefill
in one pass, the recurrent ones (falcon-mamba-7b, recurrentgemma-9b) and
encdec (seamless-m4t-large-v2, from zero encoder memory, as the
reference) through the decode loop.  An arch with no shrinkable width
group (recurrentgemma-9b, seamless) serves the full model at ``--alpha``
below 1.  Runs on the CUDA card unless ``--device cpu`` is given, and
raises without one.  ``--reduced`` (the default) serves the config's
smoke variant; ``--full`` its published widths.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import shrinking
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.models.registry import Model, build_model
from repro_torch.utils.pytree import tree_map


def prefill_into_cache(model: Model, params, tokens: torch.Tensor,
                       cache_len: int):
    """Fill the decode cache from the prompt.

    The attention families use the batched one-pass prefill
    (``transformer.prefill_lm``); the others step the decode path over
    the prompt, as the reference does: the recurrent families carry O(1)
    state, and encdec starts from ``init_cache``'s zero cross-attention
    K/V (``encdec.prefill_encdec_cache`` fills them for a caller that
    has frames)."""
    cfg = model.cfg
    if cfg.family in ("dense", "vlm", "moe"):
        return T.prefill_lm(params, tokens, cfg, cache_len)
    B, S = tokens.shape
    cache = model.init_cache(B, cache_len, tokens.device)
    logits = None
    for t in range(S):
        logits, cache = model.decode(params, cache,
                                     {"tokens": tokens[:, t:t + 1]})
    return logits, cache


def _owned(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a contiguous copy of it where it is a view into a larger
    storage (a shrunk leaf), so the full model's storage can be freed."""
    if t.untyped_storage().nbytes() > t.numel() * t.element_size():
        return t.clone(memory_format=torch.contiguous_format)
    return t


def submodel(cfg, params, alpha: float, *, round_to: int = 1):
    """The anycost alpha sub-model (Fig. 5d): EMS channel sort, then
    shrink, each shrunk leaf copied out as the reference's ``jnp.take``
    copies it.  Returns ``(cfg, params, widths)``, or None when the arch
    has no shrinkable groups."""
    spec = shrinking.transformer_shrink_spec(cfg, params, round_to=round_to)
    if not spec.groups:
        return None
    sub = shrinking.shrink(shrinking.sort_channels(params, spec), alpha, spec)
    return (shrinking.shrunk_config(cfg, alpha, spec), tree_map(_owned, sub),
            spec.widths(alpha))


def _clock(device: torch.device) -> float:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    # repro: ignore[unseeded-randomness] — a latency probe for the printed
    # report; it never feeds model state
    return time.perf_counter()


def generate(model: Model, params, prompt: torch.Tensor, n_dec: int) -> dict:
    """Prefill ``prompt`` (B, S) into a cache of ``S + n_dec`` slots, then
    greedy-decode: ``n_dec`` tokens, the first from the prefill's logits.
    Returns the tokens (B, n_dec), the last step's logits and the seconds
    of the prefill and of the decode loop."""
    t0 = _clock(prompt.device)
    logits, cache = prefill_into_cache(model, params, prompt,
                                       prompt.shape[1] + n_dec)
    t_prefill = _clock(prompt.device) - t0
    logits = logits[:, -1:].contiguous()    # frees the prompt's logits
    tok = logits.argmax(-1).to(torch.int32)
    out_tokens = [tok]
    t0 = _clock(prompt.device)
    for _ in range(n_dec - 1):
        logits, cache = model.decode(params, cache, {"tokens": tok})
        tok = logits[:, -1:].argmax(-1).to(torch.int32)
        out_tokens.append(tok)
    t_decode = _clock(prompt.device) - t0
    return {"tokens": torch.cat(out_tokens, dim=1), "logits": logits,
            "prefill_s": t_prefill, "decode_s": t_decode}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-7b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--decode-tokens", type=int, default=16)
    ap.add_argument("--alpha", type=float, default=1.0,
                    help="anycost sub-model width for serving (Fig. 5d)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = model.init(gen, device)

    if args.alpha < 1.0:
        cut = submodel(cfg, params, args.alpha)
        if cut is not None:
            cfg, params, widths = cut
            model = build_model(cfg)
            print(f"serving alpha={args.alpha} sub-model (widths: {widths})")
        else:
            print("arch has no shrinkable groups; serving full model")

    rng = np.random.default_rng(args.seed)
    prompt = torch.tensor(rng.integers(0, cfg.vocab_size,
                                       (args.batch, args.prompt_len)),
                          dtype=torch.int32, device=device)
    out = generate(model, params, prompt, args.decode_tokens)
    t_decode = out["decode_s"]
    if not bool(torch.isfinite(out["logits"]).all()):
        raise FloatingPointError("non-finite logits")
    print(f"prefill {args.prompt_len} toks x{args.batch}: "
          f"{out['prefill_s']:.2f}s; "
          f"decode {args.decode_tokens} toks: {t_decode:.2f}s "
          f"({args.batch * (args.decode_tokens - 1) / max(t_decode, 1e-9):.1f} tok/s)")
    print("sample:", out["tokens"][0].cpu().numpy()[:16])

if __name__ == "__main__":
    main()
