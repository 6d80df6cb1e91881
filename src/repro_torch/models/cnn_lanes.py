"""The CNNs of :mod:`cnn` with the lane axis written out, for the client
pool's vmapped step.

The pool trains a group of same-width clients ("lanes") with one
``torch.func.vmap`` of the loss's gradient a step.  Left to vmap's
per-op batching rules, each convolution becomes a cuDNN grouped
convolution (``groups`` = lanes) in NCHW, around which cuDNN transposes
and whose float32 engines are slow on the device and, for the
backward, block the host; each weight is transposed from HWIO twice a
step, and each max-pool folds the lanes into the batch and back.

:func:`lane_grad` gives the function the pool vmaps instead: the
gradient of the loss in the parameters, computed as one
``torch.autograd.Function`` with a ``vmap`` rule for the forward, the
loss's gradient in the logits, and a second such function for the
backward.  The rules receive the physical tensors, images ``(L, N, H,
W, C)`` and leaves ``(L, ...)`` (or unbatched, where every lane starts
from one model), and run all ``L`` lanes at once, activations
lane-major ``(L, N, H, W, C)``:

* each convolution as one batched GEMM over lanes on a card: the
  SAME-padded input unfolded to ``(L, N*H*W, kh*kw*C)`` (one copy, ``C``
  zero-padded to a multiple of 4) times the HWIO leaf seen as ``(L,
  kh*kw*ci, co)``, which needs no conversion but that padding (elsewhere
  one framework convolution a lane, :func:`_gemm`);
* ReLU in place, max-pool on the view ``(L*N, C, H, W)`` channels-last,
  which is the same memory;
* the flatten in each lane's (H, W, C) order, which is that memory
  again, and the dense layers as ``baddbmm`` over lanes.

The backward's rule writes the backward out on the same layouts: each
weight's gradient one GEMM of the saved unfolded input with the
output's gradient (its sum over pixels split into chunks, which the
GEMM batches), straight into its HWIO leaf layout; the input's
gradient one GEMM of the unfolded output gradient with the flipped
weight; ``max_pool2d_with_indices_backward`` and ``threshold_backward``
on the views.  Between the two, the caller's loss (the pool's
``loss_fn``, of a model whose logits are given) is differentiated by
``torch.func.grad`` in the ``(N, classes)`` logits alone: a handful of
small operations, where ``grad`` of the whole network would wrap every
leaf and generate autograd classes a call for the two functions.
What the forward keeps for the backward (the unfolded inputs, the ReLU
outputs, the pools' indices, the leaves as the rule saw them) stays in
the physical layout on a holder that the one call hands from the one
function to the other.

A lane sums each convolution in another order than :func:`cnn.apply_cnn`
on one client, so the gradients agree up to float32 rounding.  Called
outside vmap, both functions run the same code with one lane.

The unfolded inputs make a step hold several times the memory of vmap's
batching (:func:`lane_bytes`); the pool trains a group larger than the
card's free memory holds in runs of :func:`lanes_that_fit` lanes.
"""
from __future__ import annotations

import dataclasses
import math
import sys
from typing import Callable, NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.utils.pytree import tree_leaves, tree_unflatten

_aten = torch.ops.aten


class _Conv(NamedTuple):
    pool: bool          # a 2x2 max-pool after the ReLU
    w: int              # the leaves' indices in sorted-key order
    b: int


class _Dense(NamedTuple):
    relu: bool
    w: int
    b: int


@dataclasses.dataclass(frozen=True)
class _Plan:
    """The layers, in order.  A dataclass and not a tuple: functorch
    flattens a function's arguments as pytrees, and would walk a tuple's
    every field on every call."""
    convs: tuple
    denses: tuple
    n_leaves: int


def plan(params: dict) -> _Plan:
    """The layers of a :mod:`cnn` parameter tree, as ``apply_cnn`` reads
    them: VGG-9 (``conv3`` present) pools after every second convolution,
    the FMNIST CNN after each; every dense layer but the last has a
    ReLU.  The convolutions are stride 1, SAME, with odd kernels, whose
    pad is the same on both sides."""
    index, k = {}, 0
    for n in sorted(params):
        for leaf in sorted(params[n]):
            index[n, leaf] = k
            k += 1
    convs = sorted((n for n in params if n.startswith("conv")),
                   key=lambda n: int(n[4:]))
    denses = sorted((n for n in params if n.startswith("dense")),
                    key=lambda n: int(n[5:]))
    for n in convs:
        kh, kw = params[n]["w"].shape[:2]
        if kh % 2 == 0 or kw % 2 == 0:
            raise ValueError(f"{n}: a lane convolution takes an odd "
                             f"kernel; got {(kh, kw)}")
    vgg = "conv3" in params
    return _Plan(
        tuple(_Conv(i % 2 == 0 if vgg else True, index[n, "w"],
                    index[n, "b"]) for i, n in enumerate(convs, 1)),
        tuple(_Dense(i < len(denses), index[n, "w"], index[n, "b"])
              for i, n in enumerate(denses, 1)),
        k)


class _Holder:
    """What one forward call keeps for its backward."""
    __slots__ = ("saved",)

    def __init__(self):
        self.saved = None

    def take(self) -> list:
        saved, self.saved = self.saved, None
        if saved is None:
            raise RuntimeError("the lane CNN's backward runs once a "
                               "forward")
        return saved


def _channels(c: int) -> int:
    """``c`` channels rounded up to a multiple of 4: the unfolded rows
    and the GEMMs' operands then start on 16-byte boundaries."""
    return -(-c // 4) * 4


def _unfold(x: torch.Tensor, kh: int, kw: int) -> torch.Tensor:
    """``(L, N, H, W, C)`` -> ``(L, N*H*W, kh*kw*Cp)``: each output pixel's
    SAME-padded ``kh x kw`` window, in HWIO's (kh, kw, C) order, its
    channels zero-padded to ``Cp = _channels(C)``.  The copy moves
    16-byte groups of channels: a strided copy costs the card about as
    much for each element whatever its width."""
    n_lanes, n, h, w, c = x.shape
    cp = _channels(c)
    xp = F.pad(x, (0, cp - c, kw // 2, kw // 2, kh // 2, kh // 2))
    if (cp * xp.element_size()) % 16 == 0:
        xp, group = xp.view(torch.complex128), 16 // xp.element_size()
    else:
        group = 1
    s = xp.stride()
    return xp.as_strided((n_lanes, n, h, w, kh, kw, cp // group),
                         (s[0], s[1], s[2], s[3], s[2], s[3], s[4])) \
        .reshape(n_lanes, n * h * w, kh * kw * cp // group).view(x.dtype)


def _padded(wt: torch.Tensor, dim: int) -> torch.Tensor:
    """``wt`` zero-padded along ``dim`` (counted from the end) to
    :func:`_channels`' width."""
    c = wt.shape[dim]
    pad = [0, 0] * (-dim - 1) + [0, _channels(c) - c]
    return wt if pad[-1] == 0 else F.pad(wt, pad)


def _images(x: torch.Tensor) -> torch.Tensor:
    """Lane-major ``(L, N, H, W, C)`` -> the view ``(L*N, C, H, W)``,
    channels-last."""
    n_lanes, n, h, w, c = x.shape
    return x.reshape(n_lanes * n, h, w, c).permute(0, 3, 1, 2)


def _lane_major(x: torch.Tensor, n_lanes: int) -> torch.Tensor:
    """:func:`_images`' inverse (a view where ``x`` is channels-last)."""
    b, c, h, w = x.shape
    return x.permute(0, 2, 3, 1).reshape(n_lanes, b // n_lanes, h, w, c)


def _batched(t: torch.Tensor, dim, n_lanes: int) -> torch.Tensor:
    """A vmap rule's argument with its lane axis first (an unbatched one
    expanded, which copies nothing)."""
    if dim is None:
        return t.expand(n_lanes, *t.shape)
    return t if dim == 0 else t.movedim(dim, 0)


def _gemm(x: torch.Tensor) -> bool:
    """Whether the lanes' convolutions run as batched GEMMs: on a card,
    where cuDNN's grouped float32 engines are slow.  Elsewhere each lane
    runs the framework's own convolution, the arithmetic of each client's
    own step, so that a pooled run on the CPU trains as the per-client
    loop does.  The GEMMs sum in another order, and in float32 a unit
    within that rounding of its ReLU's zero or of its pool window's
    runner-up sends a gradient elsewhere: on the CPU, against the loop
    and the JAX package's pool on ``tests/test_torch_async.py``'s
    fmnist-cnn jobs, by 1.9e-3 of a leaf and 1.3e-2 of an update."""
    return x.is_cuda


def _conv(x: torch.Tensor, wt: torch.Tensor, b: torch.Tensor
          ) -> tuple[torch.Tensor, torch.Tensor]:
    """One SAME convolution of every lane: ``x (L, N, H, W, ci)``, ``wt
    (L, kh, kw, ci, co)``, ``b (L, co)`` -> (``(L, N, H, W, co)``, what
    :func:`_conv_backward` needs)."""
    n_lanes, n, h, w = x.shape[:4]
    kh, kw, _, co = wt.shape[1:]
    if _gemm(x):
        cols = _unfold(x, kh, kw)
        y = torch.baddbmm(b.unsqueeze(1), cols,
                          _padded(wt, -2).reshape(n_lanes, -1, co))
        return y.view(n_lanes, n, h, w, co), cols
    y = torch.stack([
        F.conv2d(x[k].permute(0, 3, 1, 2), wt[k].permute(3, 2, 0, 1), b[k],
                 padding=(kh // 2, kw // 2)).permute(0, 2, 3, 1)
        for k in range(n_lanes)])
    return y, x


def _conv_backward(g: torch.Tensor, kept: torch.Tensor, wt: torch.Tensor,
                   need_input: bool) -> tuple:
    """:func:`_conv`'s gradients from the output's ``g (L, N, H, W, co)``:
    (input's or None, ``wt``'s, ``b``'s)."""
    n_lanes = g.shape[0]
    kh, kw, ci, co = wt.shape[1:]
    if _gemm(g):
        gy = g.view(n_lanes, -1, co)
        # the weight's gradient sums over every pixel of every image: the
        # sum split into chunks of at least 512 rows, each chunk one more
        # GEMM of the batch, so that a (kh*kw*ci, co) output of a few
        # tiles still fills the card
        rows, k = gy.shape[1], kept.shape[2]
        split = math.gcd(rows, 1 << min(5, max(rows // 512, 1).bit_length()
                                        - 1))
        gw = torch.bmm(kept.reshape(n_lanes * split, -1, k).transpose(1, 2),
                       gy.reshape(n_lanes * split, -1, co)) \
            .view(n_lanes, split, kh, kw, -1, co).sum(1)[:, :, :, :ci]
        gx = None
        if need_input:
            # the padded output gradient's windows times the weight
            # flipped in (kh, kw), in and out swapped
            wf = _padded(wt.flip(1, 2).transpose(3, 4), -2)
            gx = torch.bmm(_unfold(g, kh, kw),
                           wf.reshape(n_lanes, -1, ci)) \
                .view(*g.shape[:4], ci)
        return gx, gw, gy.sum(1)
    out = [_aten.convolution_backward(
        g[k].permute(0, 3, 1, 2), kept[k].permute(0, 3, 1, 2),
        wt[k].permute(3, 2, 0, 1), [co], [1, 1], [kh // 2, kw // 2],
        [1, 1], False, [0, 0], 1, [need_input, True, True])
        for k in range(n_lanes)]
    gx = torch.stack([o[0].permute(0, 2, 3, 1) for o in out]) \
        if need_input else None
    return (gx, torch.stack([o[1].permute(2, 3, 1, 0) for o in out]),
            torch.stack([o[2] for o in out]))


def _forward(p: _Plan, images: torch.Tensor, leaves: list
             ) -> tuple[torch.Tensor, list]:
    """All lanes' forward: images ``(L, N, H, W, C)``, leaves ``(L, ...)``
    -> (logits ``(L, N, classes)``, what the backward needs)."""
    n_lanes, n = images.shape[:2]
    dtype = images.dtype
    x, convs = images, []
    for cv in p.convs:
        y, kept = _conv(x, leaves[cv.w].to(dtype), leaves[cv.b].to(dtype))
        a = y.relu_()
        idx = None
        x = a
        if cv.pool:
            x, idx = _aten.max_pool2d_with_indices(_images(a), [2, 2],
                                                   [2, 2])
            x = _lane_major(x, n_lanes)
        convs.append((kept, a, idx))
    x = x.reshape(n_lanes, n, -1)   # each lane's features, (H, W, C) order
    acts = []
    for d in p.denses:
        acts.append(x)
        x = torch.baddbmm(leaves[d.b].to(dtype).unsqueeze(1), x,
                          leaves[d.w].to(dtype))
        if d.relu:
            x = x.relu_()
    return x, [convs, acts, leaves]


def _backward(p: _Plan, g: torch.Tensor, saved: list) -> list:
    """All lanes' backward from the logits' gradient ``g (L, N, classes)``
    and :func:`_forward`'s saved state: each leaf's gradient in its
    layout ``(L, ...)``, in sorted-key order."""
    convs, acts, leaves = saved
    n_lanes, n = g.shape[:2]
    grads = [None] * p.n_leaves
    for d, a in zip(reversed(p.denses), reversed(acts)):
        wt = leaves[d.w]
        grads[d.w] = torch.bmm(a.transpose(1, 2), g).to(wt.dtype)
        grads[d.b] = g.sum(1).to(wt.dtype)
        g = torch.bmm(g, wt.to(g.dtype).transpose(1, 2))
        if a is not acts[0]:
            g = _aten.threshold_backward(g, a, 0)
    for i in range(len(p.convs) - 1, -1, -1):
        cv, (kept, a, idx) = p.convs[i], convs[i]
        wt = leaves[cv.w]
        if cv.pool:
            h, w = a.shape[2] // 2, a.shape[3] // 2
            g = _aten.max_pool2d_with_indices_backward(
                _images(g.reshape(n_lanes, n, h, w, a.shape[4])),
                _images(a), [2, 2], [2, 2], [0, 0], [1, 1], False, idx)
            g = _lane_major(g, n_lanes)
        g = _aten.threshold_backward(g.reshape(a.shape), a, 0)
        g, gw, gb = _conv_backward(g, kept, wt.to(g.dtype), i > 0)
        grads[cv.w], grads[cv.b] = gw.to(wt.dtype), gb.to(wt.dtype)
    return grads


class _Forward(torch.autograd.Function):
    """The network's forward over lanes: ``(plan, holder, images,
    *leaves)`` -> logits, the rest on ``holder``.  Not differentiable:
    :func:`lane_grad` runs the backward itself."""

    @staticmethod
    def forward(p, holder, images, *leaves):
        logits, holder.saved = _forward(p, images[None],
                                        [t[None] for t in leaves])
        return logits[0]

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, p, holder, images, *leaves):
        lanes = info.batch_size
        logits, holder.saved = _forward(
            p, _batched(images, in_dims[2], lanes),
            [_batched(t, d, lanes) for t, d in zip(leaves, in_dims[3:])])
        return logits, 0


class _Backward(torch.autograd.Function):
    """The network's backward over lanes: ``(plan, holder, g)`` -> the
    leaves' gradients."""

    @staticmethod
    def forward(p, holder, g):
        return tuple(x[0] for x in _backward(p, g[None], holder.take()))

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, p, holder, g):
        out = _backward(p, _batched(g, in_dims[2], info.batch_size),
                        holder.take())
        return tuple(out), (0,) * len(out)


def lane_bytes(params: dict, images: torch.Tensor) -> int:
    """An upper estimate of the device memory one lane of a group holds
    at once, on a card: its stacked minibatches ``images (steps, N, H,
    W, C)`` and labels, three copies of its ``params`` (the step's
    parameters, gradient and update), what :func:`_forward` keeps for the
    backward (each convolution's unfolded input and ReLU output, each
    pool's indices, each dense layer's input) and the largest of
    :func:`_backward`'s working sets (an unfolded output gradient beside
    the output's and the input's gradients)."""
    p, leaves = plan(params), tree_leaves(params)
    n, h, w = images.shape[1:4]
    kept = work = 0
    for cv in p.convs:
        kh, kw, ci, co = leaves[cv.w].shape
        kept += h * w * (kh * kw * _channels(ci) + co)
        work = max(work, h * w * (kh * kw * _channels(co) + 2 * co + ci))
        if cv.pool:
            h, w = h // 2, w // 2
            kept += h * w * co * 2          # int64 indices
    kept += sum(leaves[d.w].shape[0] for d in p.denses)
    steps = images.shape[0]
    return (images[0, 0].numel() * n * steps + 2 * n * steps  # int64 labels
            + n * (kept + work) + 3 * sum(t.numel() for t in leaves)
            ) * images.element_size()


def lanes_that_fit(params: dict, images: torch.Tensor) -> int:
    """How many lanes of :func:`lane_bytes` the card's free memory (its
    own and the allocator's cached) holds, leaving a tenth; no limit
    off a card."""
    if not images.is_cuda:
        return sys.maxsize
    free = torch.cuda.mem_get_info(images.device)[0] \
        + torch.cuda.memory_reserved(images.device) \
        - torch.cuda.memory_allocated(images.device)
    return max(1, int(0.9 * free) // lane_bytes(params, images))


def lane_grad(loss: Callable) -> Callable:
    """``fn(params, batch)`` -> the gradient tree of ``loss(logits,
    batch)`` in a CNN's ``params``, the logits :func:`cnn.apply_cnn`'s of
    ``batch["images"]``: the forward, ``torch.func.grad`` of ``loss`` in
    the logits alone, the backward.  Under ``torch.func.vmap`` every lane
    at once; outside it, one lane."""
    dloss = torch.func.grad(loss)

    def fn(params: dict, batch: dict) -> dict:
        p, holder = plan(params), _Holder()
        logits = _Forward.apply(p, holder, batch["images"],
                                *tree_leaves(params))
        return tree_unflatten(params, _Backward.apply(
            p, holder, dloss(logits, batch)))
    return fn
