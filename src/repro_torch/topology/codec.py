"""Backhaul codec: the wire encoding of a shipped ``(num, den)`` partial.

* ``f32``  -- identity: the partial's own planes, no copy (a 1-cell
  hierarchy stays the flat run).
* ``bf16`` -- both planes cast to bfloat16 (round to nearest even);
  2x smaller.
* ``int8`` -- per-leaf, per-plane symmetric amax scaling:
  ``scale = max(amax, 1e-30) / 127`` in float32, then
  ``clip(round(x / scale), -127, 127)`` (round half to even); 4x smaller
  plus one float32 scale per leaf per plane.

Bits are exact: the planes at the encoded width plus the int8 scale
headers.  The planes are the flat ``(N,)`` vectors of
``core/aggregation.PartialAgg``; a leaf is a segment of them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.core import aggregation
from repro_torch.utils.pytree import tree_leaves

PyTree = Any

CODECS = ("f32", "bf16", "int8")
_PLANE_BITS = {"f32": 32, "bf16": 16, "int8": 8}
_SCALE_HEADER_BITS = 32          # one float32 amax scale per leaf per plane


@dataclasses.dataclass
class EncodedPartial:
    """A wire-encoded (num, den) partial plus its exact bit size."""
    codec: str
    num: torch.Tensor                  # flat plane at the encoded dtype
    den: torch.Tensor
    num_scale: Optional[torch.Tensor]  # (n_leaves,) float32 (int8 only)
    den_scale: Optional[torch.Tensor]
    template: PyTree
    count: int
    bits: float


def payload_factor(codec: str) -> float:
    """Wire size of a partial / S_bits (headerless): two planes at the
    encoded width over the float32 update width."""
    if codec not in CODECS:
        raise ValueError(f"unknown backhaul codec {codec!r}; "
                         f"expected one of {CODECS}")
    return 2.0 * _PLANE_BITS[codec] / 32.0


def payload_bits(n_elems: int, n_leaves: int, codec: str) -> float:
    """Exact encoded size in bits of one shipped partial."""
    bits = 2.0 * _PLANE_BITS[codec] * n_elems
    if codec == "int8":
        bits += 2.0 * _SCALE_HEADER_BITS * n_leaves
    return bits


def _leaf_sizes(template: PyTree) -> list[int]:
    return [x.numel() for x in tree_leaves(template)]


def _per_element(scale: torch.Tensor, sizes: list[int]) -> torch.Tensor:
    counts = torch.tensor(sizes, device=scale.device)
    return torch.repeat_interleave(scale, counts)


def _encode_plane_int8(x: torch.Tensor, sizes: list[int]
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    amax = torch.stack([seg.abs().max() for seg in torch.split(x, sizes)])
    scale = torch.clamp(amax, min=1e-30) / 127.0
    q = torch.clamp(torch.round(x / _per_element(scale, sizes)), -127, 127)
    return q.to(torch.int8), scale


def encode_partial(part: aggregation.PartialAgg,
                   codec: str = "f32") -> EncodedPartial:
    """Encode a partial for the backhaul hop.  ``f32`` hands over the
    partial's own planes (no copy); the others make new ones."""
    if codec not in CODECS:
        raise ValueError(f"unknown backhaul codec {codec!r}; "
                         f"expected one of {CODECS}")
    sizes = _leaf_sizes(part.template)
    bits = payload_bits(sum(sizes), len(sizes), codec)
    if codec == "f32":
        return EncodedPartial(codec, part.num, part.den, None, None,
                              part.template, part.count, bits)
    if codec == "bf16":
        return EncodedPartial(codec, part.num.to(torch.bfloat16),
                              part.den.to(torch.bfloat16), None, None,
                              part.template, part.count, bits)
    qn, sn = _encode_plane_int8(part.num, sizes)
    qd, sd = _encode_plane_int8(part.den, sizes)
    return EncodedPartial(codec, qn, qd, sn, sd, part.template, part.count,
                          bits)


def decode_partial(enc: EncodedPartial) -> aggregation.PartialAgg:
    """Inverse of :func:`encode_partial`: exact (the same planes) for
    ``f32``, dequantized float32 planes otherwise."""
    if enc.codec == "f32":
        num, den = enc.num, enc.den
    elif enc.codec == "bf16":
        num, den = enc.num.float(), enc.den.float()
    else:
        sizes = _leaf_sizes(enc.template)
        num = enc.num.float() * _per_element(enc.num_scale, sizes)
        den = enc.den.float() * _per_element(enc.den_scale, sizes)
    return aggregation.PartialAgg(num=num, den=den, template=enc.template,
                                  count=enc.count)
