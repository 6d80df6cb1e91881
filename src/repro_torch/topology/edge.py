"""Edge tier: stream local uplinks into one O(N) partial per cell.

An :class:`EdgeAggregator` is the server of one cell.  It folds each
arriving update into its flat ``(num, den)`` accumulator the moment the
uplink lands (``core/aggregation.partial_absorb``: one ``aio_absorb``
launch on the card) and never stores the update, so edge memory does
not grow with the cell's clients.  At the cell's barrier it ships the
partial over the backhaul; the cloud merges the partials in place
(:func:`cloud_merge`, one ``aio_merge`` launch per extra cell) and
finalizes Eq. 5 once (:func:`finalize_apply`).

Every absorb and merge writes into the accumulator's own storage: a
partial that was shipped, or merged into another, must not be read
again by its caller.
"""
from __future__ import annotations

from typing import Any, Optional

from repro_torch.core import aggregation
from repro_torch.topology.codec import (EncodedPartial, decode_partial,
                                        encode_partial)
from repro_torch.utils.pytree import tree_map

PyTree = Any


def finalize_apply(params: PyTree, part: aggregation.PartialAgg,
                   server_lr: float = 1.0) -> PyTree:
    """One server step from a merged partial: ``w - server_lr * Eq. 5``."""
    agg = aggregation.partial_finalize(part)
    return tree_map(
        lambda p, g: (p.float() - server_lr * g.float()).to(p.dtype),
        params, agg)


class EdgeAggregator:
    """Streaming per-cell accumulator with absorb/ship bookkeeping."""

    def __init__(self, cell_id: int, template: PyTree):
        self.cell_id = cell_id
        self.part = aggregation.partial_init(template)

    def absorb(self, values: PyTree, mask: PyTree, weight: float) -> None:
        """Fold one uplink in place; ``weight`` is the client's
        *unnormalized* coefficient (Eq. 5's ratio cancels
        normalization)."""
        aggregation.partial_absorb(self.part, values, mask, weight)

    def ship(self) -> aggregation.PartialAgg:
        """Hand the partial to the cloud; the edge keeps no reference."""
        part, self.part = self.part, None
        return part


class CodecErrorFeedback:
    """Per-cell residuals of the lossy backhaul codec, across rounds.

    Round t ships ``encode(partial_t + residual_t)`` and keeps
    ``residual_{t+1} = (partial_t + residual_t) - decode(shipped)``, the
    mass the wire dropped.  Residuals live in the round's sorted
    coordinate frame: the caller passes a ``frame`` token (the channel
    sort permutations), and a residual stored under another frame is
    dropped rather than added into the wrong channels."""

    def __init__(self):
        # cell_id -> (frame, num_res, den_res)
        self._res: dict[int, tuple] = {}

    def encode_ship(self, cell_id: int, part: aggregation.PartialAgg,
                    codec: str, frame=None) -> EncodedPartial:
        """Residual-corrected :func:`encode_partial`.  The residual is
        computed here, before the cloud merges anything into the
        decoded planes."""
        if codec == "f32":
            return encode_partial(part, codec)   # exact wire: no residual
        stored = self._res.get(cell_id)
        if stored is not None and stored[0] == frame:
            part = aggregation.PartialAgg(
                num=part.num + stored[1], den=part.den + stored[2],
                template=part.template, count=part.count)
        enc = encode_partial(part, codec)
        dec = decode_partial(enc)
        self._res[cell_id] = (frame, part.num - dec.num,
                              part.den - dec.den)
        return enc


def cloud_merge(partials: list[aggregation.PartialAgg]
                ) -> Optional[aggregation.PartialAgg]:
    """Fuse the per-cell partials the backhaul delivered (any order): the
    first is the running accumulator and every other merges into it in
    place, so the cloud's live state is one O(N) pair however many cells
    report.  None when no cell reported."""
    if not partials:
        return None
    merged = partials[0]
    for part in partials[1:]:
        aggregation.partial_merge(merged, part)
    return merged
