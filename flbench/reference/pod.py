"""The pod step in plain PyTorch: the family's loss and gradients
(``reference/lm_<family>.py``), AnycostFL's gradient sync across pods and
AdamW, followed from the seed through the checked steps.

The sync (the paper's FGC and AIO with each pod one device) compresses
each pod's gradient leaf by leaf: a magnitude threshold from a
half-normal fit, ``std * sqrt(2) * erfinv(1 - keep_frac)`` with ``std``
the leaf's root mean square; the kept coordinates (``|g| >= threshold``)
coded as int8 levels of ``amax / 127`` (``amax`` the largest kept
magnitude); then Eq. 5 with unit weights over the deployment's pods:
each coordinate is the mean of the coded values of the pods that kept
it, 0 where none did.  The card runs one pod; the others' levels and
masks are its own, rolled (``bench/lm_inputs.pod_rows``), with its
scale.  AdamW
(Loshchilov and Hutter) with bias correction and a linear warm-up of the
rate, ``lr * min(t / warmup, 1)`` at step ``t`` from 1, moments in
float32, the parameters stored back in the configuration's dtype.

What a run records of the checked steps: ``loss`` (each step's),
``grad`` (each leaf's, a layer's slice of a stacked leaf, norm of the
first step's gradient as the optimizer got it: its first moment after
that step over ``1 - b1``) and ``change`` (each slice's norm of the
parameters' change over the checked steps); the program's capture has
the same keys.  The reference's also has ``raw``, each slice's norm of
the first step's gradient before the sync.  ``mode="fp8"`` (the
control) runs every product of the family's layers with both operands
rounded to float8 e4m3, each scaled by its largest magnitude as a
float8 product would be.
"""
from __future__ import annotations

import contextlib
import importlib
import math

import torch

from bench import lm_inputs

F32 = torch.float32
#: float8 e4m3's largest finite value
E4M3_MAX = 448.0


def family(config: dict):
    """``reference/lm_<family>.py`` of the configuration's model."""
    return importlib.import_module(
        f"reference.lm_{config['model']['family']}")


@contextlib.contextmanager
def float32_products():
    """TF32 off, as the configuration's float32 means it."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 at the scale of its largest
    magnitude, in float32; the gradient passes through unchanged."""
    scale = x.detach().abs().amax().clamp(min=1e-30) / E4M3_MAX
    q = (x.detach() / scale).to(torch.float8_e4m3fn).to(F32) * scale
    return x + (q - x.detach())


def fp8_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return _fp8(x) @ _fp8(w)


#: elements a chunk of a leaf's elementwise work (bounds the transients)
CHUNK = 1 << 24


def _chunks(*xs):
    """Matching flat chunks of equally sized tensors."""
    flat = [x.view(-1) for x in xs]
    n = flat[0].numel()
    for a in range(0, n, CHUNK):
        yield [f[a:a + CHUNK] for f in flat]


def sync(g: torch.Tensor, traffic: dict, seed: int) -> torch.Tensor:
    """One pod's leaf ``g`` (float32) synced, in place: the leaf's
    threshold and ``amax``, its int8 levels and keep mask, the other
    pods' rows drawn from them, then Eq. 5 chunk by chunk."""
    n, keep_frac = g.numel(), traffic["keep_frac"]
    sumsq = sum(float(c.double().square().sum()) for (c,) in _chunks(g))
    quant = float(torch.special.erfinv(
        torch.tensor(1.0 - keep_frac, dtype=torch.float64)))
    thr = math.sqrt(sumsq / n + 1e-30) * math.sqrt(2.0) * quant
    amax = max(float(torch.where(c.abs() >= thr, c.abs(), 0.0).max())
               for (c,) in _chunks(g))
    scale = torch.tensor(max(amax, 1e-12) / 127.0, dtype=F32)
    levels = torch.empty(n, dtype=torch.int8, device=g.device)
    keep = torch.empty(n, dtype=torch.int8, device=g.device)
    for c, lc, kc in _chunks(g, levels, keep):
        k = c.abs() >= thr
        kc.copy_(k)
        lc.copy_((c / scale.to(c.device)).round().clamp(-127, 127)
                 .masked_fill_(~k, 0.0))
    levels = lm_inputs.pod_rows(seed, levels, traffic["peer_pods"])
    keep = lm_inputs.pod_rows(seed, keep, traffic["peer_pods"])
    flat = g.view(-1)
    for a in range(0, n, CHUNK):
        m = keep[:, a:a + CHUNK].to(F32)
        num = (m * (levels[:, a:a + CHUNK].to(F32)
                    * scale.to(g.device))).sum(0)
        den = m.sum(0)
        flat[a:a + CHUNK] = torch.where(den > 0, num / den.clamp(min=1e-12),
                                        0.0)
    return g


class AdamW:
    def __init__(self, opt: dict, params: dict):
        self.o = opt
        self.t = 0
        self.m = {k: torch.zeros_like(p, dtype=F32) for k, p in params.items()}
        self.v = {k: torch.zeros_like(p, dtype=F32) for k, p in params.items()}

    @torch.no_grad()
    def step(self, params: dict, grads: dict) -> None:
        """One update of every leaf, chunk by chunk; ``grads`` is emptied
        as it goes."""
        o = self.o
        self.t += 1
        t = self.t
        lr = o["lr"] * (min(t / o["warmup"], 1.0) if o["warmup"] else 1.0)
        bc1, bc2 = 1 - o["b1"] ** t, 1 - o["b2"] ** t
        for k, p in params.items():
            g = grads.pop(k)
            for pc, gc, mc, vc in _chunks(p, g, self.m[k], self.v[k]):
                mc.mul_(o["b1"]).add_(gc, alpha=1 - o["b1"])
                vc.mul_(o["b2"]).add_(gc.square(), alpha=1 - o["b2"])
                upd = (mc / bc1) / ((vc / bc2).sqrt() + o["eps"])
                pf = pc.float()
                upd.add_(pf, alpha=o["weight_decay"])
                pc.copy_(pf.sub_(upd, alpha=lr))
            del g


def grad_norms(layout, m: dict, b1: float, stacked) -> dict:
    """Each slice's norm of the first step's gradient as the optimizer
    got it, from its first moments after that step (or of a gradient
    itself, ``b1`` 0)."""
    out = {}
    for path, _, _ in layout:
        out.update({k: n / (1 - b1) for k, n in lm_inputs.slice_norms(
            path, m[path], stacked(path)).items()})
    return out


def change_norms(layout, seed: int, dtype, device, params: dict,
                 stacked) -> dict:
    """Each slice's norm of the change from the seed's weights."""
    out = {}
    for i, (path, shape, init) in enumerate(layout):
        start = lm_inputs.draw_leaf(seed, i, shape, init, dtype, device)
        out.update(lm_inputs.slice_norms(path, params[path], stacked(path),
                                         start=start))
        del start
    return out


def train(config: dict, traffic: dict, seed: int, device, steps: int, *,
          mode: str = "f32") -> dict:
    """The checked steps from the seed, one pod: the record (module
    docstring)."""
    fam = family(config)
    mm = fp8_matmul if mode == "fp8" else fam.matmul
    dtype = getattr(torch, config["model"]["dtype"])
    layout = fam.leaves(config["model"])
    params = lm_inputs.weights(seed, layout, dtype, device)
    docs = lm_inputs.TokenDocs(seed, traffic, config["model"]["vocab_size"],
                               device)
    opt = AdamW(traffic["optimizer"], params)
    rec = {"loss": []}
    with float32_products():
        for t in range(steps):
            loss, grads = fam.loss_and_grads(params, docs.batch(t), config,
                                             mm)
            rec["loss"].append(loss)
            if t == 0:
                rec["raw"] = grad_norms(layout, grads, 0.0, fam.stacked)
            for g in grads.values():
                sync(g, traffic, seed)
            opt.step(params, grads)
            if t == 0:
                rec["grad"] = grad_norms(layout, opt.m,
                                         traffic["optimizer"]["b1"],
                                         fam.stacked)
        del opt
        rec["change"] = change_norms(layout, seed, dtype, device, params,
                                     fam.stacked)
    return rec


def compare(prog: dict, ref: dict) -> dict:
    """The numbers ``correct`` is judged on: ``loss_gap`` (the first
    step's relative gap of losses: both sides start it from the same
    weights and rows), ``grad_gap`` and ``update_gap`` (the worst slice's
    gap of norms over the larger of its reference norm and the median
    slice's) and ``grad_median_gap`` (the median slice's ``grad_gap``);
    slices whose first gradient in the reference, before the sync, is
    under a thousandth of the median slice's (nought but rounding, moved
    by round-off alone) are left out of ``update_gap``.  The later steps'
    loss gaps are read beside them: Adam's first step moves every kept
    coordinate by the whole rate, so a coordinate kept on one side alone
    parts the two, and their losses part by up to a hundred times the
    first step's."""
    steps = [abs(a - b) / abs(b) for a, b in zip(prog["loss"], ref["loss"])]
    grads = _gaps(prog["grad"], ref["grad"])
    raw_med = _median(ref["raw"].values())
    moved = [k for k, g in ref["raw"].items() if g >= 1e-3 * raw_med]
    nums = {"loss_gap": steps[0], "grad_gap": max(grads),
            "grad_median_gap": _median(grads),
            "update_gap": max(_gaps({k: prog["change"][k] for k in moved},
                                    {k: ref["change"][k] for k in moved})),
            "still_slices": float(len(ref["grad"]) - len(moved))}
    nums.update({f"loss_gap.step{t + 1}": g
                 for t, g in enumerate(steps) if t})
    return nums


def _median(values) -> float:
    v = sorted(values)
    return 0.5 * (v[(len(v) - 1) // 2] + v[len(v) // 2])


def _gaps(prog: dict, ref: dict) -> list[float]:
    """Each slice's gap of norms over the larger of its reference norm
    and the median slice's."""
    med = _median(ref.values())
    return [abs(prog[k] - r) / max(r, med) for k, r in ref.items()]
