"""Inputs of the pod cells, made from ``--seed`` and handed to both sides.

* The initial weights: each leaf of the family reference's layout
  (``reference/lm_<family>.leaves``: dotted path, shape, init) drawn on
  the run's device in one call, from a ``torch.Generator`` seeded from
  ``(seed, leaf index)``, in the configuration's dtype: ``("normal",
  std)`` is standard normal times ``std``, ``"ones"`` is ones.  Any leaf
  can be drawn again alone, so the program's change after the checked
  steps and the reference's start are worked out from the same numbers.
* The token documents (:class:`TokenDocs`): step ``t``'s ``(batch,
  seq_len)`` rows, drawn on the device from ``(seed, t)``: each row takes
  a topic, and its tokens follow a Zipf law over the vocabulary in that
  topic's order of the ids (``traffic["tokens"]``: ``exponent``,
  ``topics``).
* The other pods' rows of the sync (:func:`pod_rows`): a deployment of
  ``1 + peers`` pods runs one pod on the card; each other pod's payload
  and keep mask are this pod's, flattened and rolled by a shift drawn
  from ``(seed, pod, length)``, with this pod's scale: the same sparsity
  and magnitudes at other coordinates, and payload and mask rolled alike.
"""
from __future__ import annotations

import torch

from bench.inputs import child_seed

_WEIGHTS, _TOPICS, _STEP, _PEER = 0x3E1, 0x70C, 0x57E, 0x9E7


def draw_leaf(seed: int, index: int, shape, init, dtype, device
              ) -> torch.Tensor:
    """Leaf ``index`` of the layout, as both sides start from it."""
    if init == "ones":
        return torch.ones(shape, dtype=dtype, device=device)
    kind, std = init
    if kind != "normal":
        raise ValueError(f"unknown init {init!r}")
    gen = torch.Generator(device=device).manual_seed(
        child_seed(seed, _WEIGHTS, index))
    return torch.randn(shape, generator=gen, dtype=dtype,
                       device=device).mul_(std)


def weights(seed: int, layout, dtype, device) -> dict:
    """{path: leaf} of the whole layout, in the layout's order."""
    return {path: draw_leaf(seed, i, shape, init, dtype, device)
            for i, (path, shape, init) in enumerate(layout)}


class TokenDocs:
    """The seeded token documents of one run (module docstring)."""

    def __init__(self, seed: int, traffic: dict, vocab: int, device):
        spec = traffic["tokens"]
        self.seed, self.device = seed, torch.device(device)
        self.shape = (traffic["batch"], traffic["seq_len"])
        ranks = torch.arange(1, vocab + 1, dtype=torch.float64)
        self.probs = ranks.pow(-float(spec["exponent"])).float().to(
            self.device)
        gen = torch.Generator(device=self.device).manual_seed(
            child_seed(seed, _TOPICS))
        self.order = torch.stack([
            torch.randperm(vocab, generator=gen, device=self.device)
            for _ in range(spec["topics"])])

    def batch(self, t: int) -> torch.Tensor:
        """Step ``t``'s int32 tokens, ``(batch, seq_len)``."""
        B, S = self.shape
        gen = torch.Generator(device=self.device).manual_seed(
            child_seed(self.seed, _STEP, t))
        topic = torch.randint(0, self.order.shape[0], (B,), generator=gen,
                              device=self.device)
        rank = torch.multinomial(self.probs, B * S, replacement=True,
                                 generator=gen).view(B, S)
        return self.order[topic[:, None], rank].to(torch.int32)


def peer_shift(seed: int, pod: int, numel: int) -> int:
    """The roll of pod ``pod``'s (1, 2, ...) row of a sync over
    ``numel`` elements."""
    return child_seed(seed, _PEER, pod, numel) % numel if numel > 1 else 0


def pod_rows(seed: int, t: torch.Tensor, peers: int) -> torch.Tensor:
    """``(1 + peers, *t.shape)``: ``t``, then each other pod's row, ``t``
    rolled by :func:`peer_shift` (``out[j] = t[(j - shift) % n]`` over
    the flattened rows)."""
    flat = t.reshape(-1)
    n = flat.numel()
    out = t.new_empty((1 + peers, n))
    out[0].copy_(flat)
    for pod in range(1, peers + 1):
        s = peer_shift(seed, pod, n)
        out[pod, s:].copy_(flat[:n - s])
        out[pod, :s].copy_(flat[n - s:])
    return out.view((1 + peers,) + tuple(t.shape))


def slice_norms(path: str, x: torch.Tensor, stacked: bool,
                start: torch.Tensor | None = None) -> dict:
    """{name: float64 L2 norm} of a leaf, or of its change from
    ``start``: one a layer of a stacked leaf (``path[i]``), the whole
    leaf otherwise."""
    rows = range(x.shape[0]) if stacked else [None]
    out = {}
    for i in rows:
        xi = x if i is None else x[i]
        d = xi.double()
        if start is not None:
            d -= (start if i is None else start[i]).double()
        out[path if i is None else f"{path}[{i}]"] = \
            torch.linalg.vector_norm(d)
        del d
    names = list(out)
    norms = torch.stack([out[k] for k in names]).tolist()
    return dict(zip(names, norms))
