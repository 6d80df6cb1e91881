"""Learning-dynamics diagnostics: streaming update/error statistics.

The system side of a run is observable through per-phase cost
attribution and traces; this module makes the *learning* side observable —
the realized counterparts of the Theorem-2 convergence terms.  A
:class:`LearningRecorder` rides the orchestrator's hot paths strictly
behind ``if tel.enabled:`` guards and emits into the run's
``MetricsRegistry`` under the ``learning.*`` namespace:

====================================  ======================  =========
metric                                labels                  semantics
====================================  ======================  =========
``learning.update_norm``              device, round           ``||u||`` of the full-coordinate update
``learning.error_energy``             device, round, phase    per-stage energy; phases ``shrink`` / ``sparsify`` / ``quantize`` partition ``||u - u_hat||^2`` exactly
``learning.error_total``              device, round           ``||u - u_hat||^2`` as one fused reduction (the decomposition's reference)
``learning.cosine_alignment``         device, round           cosine of the device's decoded update vs. the round's aggregate step
``learning.contribution_share``       device, round           staleness-discounted weighted share of the round's update mass
``learning.fairness_gini``            round                   Gini over *cumulative* per-device contributions (all devices, silent = 0)
``learning.silent_fraction``          round                   fraction of the fleet with zero cumulative contribution so far
``learning.agg_update_norm``          round                   ``||w_t - w_{t+1}||`` of the global step (divergence-spike signal)
``learning.cell_divergence``          cell, round             cosine of the cell's finalized partial vs. the global aggregate
``learning.cell_divergence_rel``      cell, round             relative L2 distance of the same pair
``learning.ef_residual_energy``       cell, round             ``||num_res||^2 + ||den_res||^2`` of the cell's backhaul EF residual
====================================  ======================  =========

Invariants.  Everything here is read-only with respect to the
simulation: no RNG stream is consumed, no tensor the training path reads
is written, and every per-device statistic is computed in its *own*
pass of plain PyTorch ops (expand -> masked squares -> per-leaf sums,
five scalars read off the device in one transfer) rather than by adding
outputs to the client's finish step — so the training path runs the
same operations, and launches the same kernels, whether telemetry is on
or off.  With telemetry off the recorder is never constructed and this
module is never imported.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core import aggregation, compression, shrinking
from repro_torch.utils.pytree import tree_l2, tree_sub

PyTree = Any


def gini(values: np.ndarray) -> float:
    """Gini coefficient of a non-negative vector (0 = perfectly equal,
    -> 1 = one member holds everything).  0.0 for empty or all-zero
    input.  O(n log n) via the sorted-rank identity."""
    x = np.sort(np.asarray(values, np.float64))
    n = x.size
    total = float(x.sum())
    if n == 0 or total <= 0.0:
        return 0.0
    ranks = np.arange(1, n + 1, dtype=np.float64)
    return float((2.0 * float(np.dot(ranks, x)) / total - (n + 1)) / n)


class LearningRecorder:
    """Per-run collector of ``learning.*`` statistics.

    Constructed by the orchestrator only when a telemetry session is
    enabled; holds the cumulative per-device contribution vector backing
    the fairness Gini and the silent-device signal.
    """

    def __init__(self, spec: shrinking.ShrinkSpec, n_devices: int):
        self.spec = spec
        self.n_devices = n_devices
        # cumulative contribution mass per device over the whole run
        # (devices never selected / never accepted stay at exactly 0)
        self.cum_contrib = np.zeros(n_devices, np.float64)
        # round-scoped scratch, cleared by record_round
        self._norms: dict[int, float] = {}
        self._entries: list[tuple[int, float]] = []

    # ------------------------------------------------- per-device statistics

    def device_stats(self, alpha: float, sub: PyTree, trained: PyTree,
                     values: PyTree, mask: PyTree
                     ) -> compression.StageErrors:
        """The five stage energies for one materialized device round.
        Recomputes the expand from ``(sub, trained)`` instead of tapping
        the finish step's intermediates, so the training path is
        untouched."""
        full_update, width_mask = shrinking.expand_update(
            tree_sub(sub, trained), None, alpha, self.spec)
        return compression.stage_error_energies(full_update, width_mask,
                                                mask, values)

    def record_device(self, tel, device: int, round_idx: int,
                      stats: compression.StageErrors) -> float:
        """Gauge one device's update norm + error decomposition; returns
        the update norm (also cached for the contribution share).  The
        five energies leave the device in one transfer."""
        norm_sq, e_shrink, e_sparsify, e_quantize, e_total = \
            torch.stack(list(stats)).tolist()
        norm = float(np.sqrt(norm_sq))
        tel.gauge("learning.update_norm", norm, device=device,
                  round=round_idx)
        for phase, e in (("shrink", e_shrink),
                         ("sparsify", e_sparsify),
                         ("quantize", e_quantize)):
            tel.gauge("learning.error_energy", e, device=device,
                      round=round_idx, phase=phase)
        tel.gauge("learning.error_total", e_total,
                  device=device, round=round_idx)
        self._norms[device] = norm
        return norm

    def record_alignment(self, tel, device: int, round_idx: int,
                         values: PyTree, agg_delta: PyTree) -> None:
        """Cosine of the device's decoded update vs. the global step."""
        cos, _ = aggregation.alignment_stats(values, agg_delta)
        tel.gauge("learning.cosine_alignment", float(cos), device=device,
                  round=round_idx)

    # -------------------------------------------------- per-cell statistics

    def record_cell(self, tel, cell: int, round_idx: int,
                    cell_agg: PyTree, agg_delta: PyTree) -> None:
        """Divergence of one cell's finalized partial vs. the global
        aggregate (finalized from the *decoded* partial before the cloud
        merge writes into its planes)."""
        cos, rel = torch.stack(
            aggregation.alignment_stats(cell_agg, agg_delta)).tolist()
        tel.gauge("learning.cell_divergence", cos, cell=cell,
                  round=round_idx)
        tel.gauge("learning.cell_divergence_rel", rel, cell=cell,
                  round=round_idx)

    def record_ef_residual(self, tel, cell: int, round_idx: int,
                           codec_ef) -> None:
        """Energy of the cell's backhaul error-feedback residual."""
        e_num, e_den = codec_ef.residual_energy(cell)
        tel.gauge("learning.ef_residual_energy", e_num + e_den,
                  cell=cell, round=round_idx)

    # ------------------------------------------- contribution / fairness

    def note_contribution(self, device: int, weight: float) -> None:
        """Queue one admitted update's contribution for this round:
        ``weight`` is the final unnormalized aggregation coefficient
        (Theorem-1 / FedAvg x any staleness discount, exactly what the
        AIO fold consumed), scaled here by the device's recorded update
        norm — mass actually moved times mass actually admitted."""
        norm = self._norms.get(device, 0.0)
        self._entries.append((device, float(weight) * norm))

    def record_round(self, tel, round_idx: int,
                     agg_delta: Optional[PyTree]) -> None:
        """Close the round: aggregate-step norm, per-device contribution
        shares, cumulative-fairness Gini, and the silent fraction."""
        if agg_delta is not None:
            tel.gauge("learning.agg_update_norm",
                      float(tree_l2(agg_delta)), round=round_idx)
        total = sum(c for _, c in self._entries)
        for device, c in self._entries:
            share = c / total if total > 0 else 0.0
            tel.gauge("learning.contribution_share", share,
                      device=device, round=round_idx)
            self.cum_contrib[device] += c
        tel.gauge("learning.fairness_gini", gini(self.cum_contrib),
                  round=round_idx)
        tel.gauge("learning.silent_fraction",
                  float(np.mean(self.cum_contrib <= 0.0)),
                  round=round_idx)
        self._norms = {}
        self._entries = []
