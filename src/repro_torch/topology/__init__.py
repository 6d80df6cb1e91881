"""Hierarchical multi-cell FL: client -> edge -> cloud.

The fleet is partitioned across cells, each with its own wireless
environment; an :class:`EdgeAggregator` per cell streams its uplinks into
one O(N) partial (the ``core/aggregation`` AIO monoid, no ``(I, N)``
stack), ships it over a modelled backhaul, and the cloud merges the cell
partials and finalizes Eq. 5 once.  ``TopologyConfig(kind="flat")`` is
the paper's single cell; a 1-cell hierarchy over a zero-cost backhaul
reproduces the flat run up to the order of the float32 sums.
"""
from repro_torch.topology.backhaul import (BackhaulConfig,
                                           sample_cell_backhauls)
from repro_torch.topology.cells import (ASSIGNMENTS, TOPOLOGIES,
                                        TopologyConfig, assign_cells,
                                        cell_sites)
from repro_torch.topology.codec import (CODECS, EncodedPartial,
                                        decode_partial, encode_partial,
                                        payload_bits, payload_factor)
from repro_torch.topology.edge import (CodecErrorFeedback, EdgeAggregator,
                                       cloud_merge, finalize_apply)

__all__ = [
    "ASSIGNMENTS", "CODECS", "TOPOLOGIES", "TopologyConfig",
    "assign_cells", "cell_sites", "BackhaulConfig",
    "sample_cell_backhauls", "CodecErrorFeedback", "EdgeAggregator",
    "EncodedPartial", "cloud_merge", "decode_partial", "encode_partial",
    "finalize_apply", "payload_bits", "payload_factor",
]
