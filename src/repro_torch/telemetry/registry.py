"""Label-keyed metrics registry: counters, gauges, histograms.

One registry instance is the structured backing store of a run's
realized telemetry.  Every metric is a ``(name, labels)`` pair — labels
are free-form ``key=value`` dimensions (``device``, ``cell``, ``phase``,
``round``) — with one of three accumulation semantics:

* **counter** — monotonically accumulating sum (``+=``); energy joules,
  bits on a wire, handover counts;
* **gauge** — last-write-wins sample (``=``); per-round means, state of
  charge, the ``round.*`` fields backing :class:`~repro_torch.train.fl_loop.
  RoundLog` views;
* **histogram** — append-only observation list; per-dispatch latencies
  and anything needing percentiles.

Values are stored verbatim (no float coercion), so a gauge read back via
:meth:`MetricsRegistry.value` is the exact object that was emitted —
which is what lets ``RoundLog.from_registry`` materialize a bitwise-
identical view of the round record.  The registry is pure host-side
Python over plain dicts: it never touches an RNG stream or a tensor,
so emitting into it cannot perturb a seeded simulation.

Fleet-scale bounds:

* A :class:`~repro_torch.telemetry.sketch.RollupPolicy` plus
  :meth:`set_fleet_size` folds device-labeled emissions into bounded
  per-cell :class:`~repro_torch.telemetry.sketch.QuantileSketch` cells and
  :class:`~repro_torch.telemetry.sketch.TopK` heavy-hitter trackers once the
  fleet reaches the policy's threshold — memory O(cells × capacity)
  instead of O(devices).  Below the threshold (or without a policy)
  nothing changes: bitwise-identical to the exact path.
* Histograms are additionally capped at ``histogram_cap`` total
  observations per name; past the cap the name's cells fold into one
  overflow sketch (labels coarsened), bounding the always-live
  ``dispatch.latency_s`` series over long fedbuff runs.  Below the cap
  :meth:`summary` is bitwise-identical to the uncapped path because no
  conversion has happened and every float op is unchanged.
"""
from __future__ import annotations

import json
from typing import Any, Iterator, Optional

from repro_torch.telemetry.sketch import QuantileSketch, RollupPolicy, TopK

COUNTER = "counter"
GAUGE = "gauge"
HISTOGRAM = "histogram"
#: pseudo-kind used only in JSONL records for heavy-hitter trackers
TOPK_KIND = "topk"

_KINDS = (COUNTER, GAUGE, HISTOGRAM)

#: per-name histogram observation budget before the exact cells fold
#: into one bounded overflow sketch
DEFAULT_HISTOGRAM_CAP = 4096
#: overflow sketch size when no rollup policy supplies one
DEFAULT_SKETCH_CAPACITY = 512

#: the label cell that holds a name's post-cap overflow sketch
_OVERFLOW_CELL: tuple = ()


def _label_key(labels: dict) -> tuple:
    """Canonical hashable identity of a label set (order-insensitive)."""
    return tuple(sorted(labels.items()))


class MetricsRegistry:
    """In-memory metric store keyed by ``(name, sorted(labels))``."""

    def __init__(self, rollup: Optional[RollupPolicy] = None,
                 histogram_cap: int = DEFAULT_HISTOGRAM_CAP):
        # name -> {label_key -> value | list | QuantileSketch}
        self._metrics: dict[str, dict[tuple, Any]] = {}
        self._kinds: dict[str, str] = {}
        self._rollup = rollup
        self._rollup_active = False
        self.fleet_size: Optional[int] = None
        self.histogram_cap = int(histogram_cap)
        # (name, reduced_label_key) -> TopK of the dropped label's values
        self._topk: dict[tuple[str, tuple], TopK] = {}
        # name -> total exact-path observation count (drives the cap)
        self._n_obs: dict[str, int] = {}

    def __len__(self) -> int:
        return sum(len(series) for series in self._metrics.values())

    @classmethod
    def from_records(cls, records) -> "MetricsRegistry":
        """Rebuild a registry from :meth:`records`-shaped dicts (e.g. a
        parsed ``metrics.jsonl``).  Stored values are installed verbatim
        — counters arrive already accumulated, sketch/top-k docs are
        re-hydrated bitwise — so a JSONL round trip is faithful for
        every JSON-representable value."""
        reg = cls()
        for rec in records:
            key = _label_key(rec.get("labels", {}))
            value = rec["value"]
            if rec["kind"] == TOPK_KIND:
                reg._topk[(rec["name"], key)] = TopK.from_dict(value)
                continue
            series = reg._series(rec["name"], rec["kind"])
            if QuantileSketch.is_doc(value):
                series[key] = QuantileSketch.from_dict(value)
            elif isinstance(value, list):
                series[key] = list(value)
                reg._n_obs[rec["name"]] = (
                    reg._n_obs.get(rec["name"], 0) + len(value))
            else:
                series[key] = value
        return reg

    def __contains__(self, name: str) -> bool:
        return name in self._metrics

    # ------------------------------------------------------------ emission

    def set_fleet_size(self, n: int) -> None:
        """Report the fleet size; engages rollup at/above the policy's
        ``device_threshold``.  Pure bookkeeping — no recording happens
        here, so callers need no telemetry guard."""
        self.fleet_size = int(n)
        self._rollup_active = (self._rollup is not None
                               and self._rollup.engages(self.fleet_size))

    @property
    def rollup_active(self) -> bool:
        return self._rollup_active

    def _series(self, name: str, kind: str) -> dict:
        have = self._kinds.get(name)
        if have is None:
            self._kinds[name] = kind
            self._metrics[name] = {}
        elif have != kind:
            raise ValueError(
                f"metric {name!r} already registered as {have}; "
                f"cannot re-emit as {kind}")
        return self._metrics[name]

    def _reduced(self, labels: dict) -> dict:
        drop = self._rollup.drop_label
        return {k: v for k, v in labels.items() if k != drop}

    def _sketch_cell(self, series: dict, name: str,
                     rkey: tuple) -> QuantileSketch:
        cell = series.get(rkey)
        if not isinstance(cell, QuantileSketch):
            cell = QuantileSketch(self._rollup.sketch_capacity,
                                  salt=self._rollup.salt_for(name, rkey))
            series[rkey] = cell
        return cell

    def _track_topk(self, name: str, rkey: tuple, device, value) -> None:
        tk = self._topk.get((name, rkey))
        if tk is None:
            tk = TopK(self._rollup.top_k,
                      salt=self._rollup.salt_for(name, rkey))
            self._topk[(name, rkey)] = tk
        tk.add(device, value)

    def counter(self, name: str, value: float = 1.0, **labels) -> None:
        """Accumulate ``value`` into the counter at ``(name, labels)``.

        Under active rollup, device-labeled counters accumulate into the
        device-stripped cell (the total is preserved; the per-device
        partition is traded for a bounded top-K of largest single
        contributions)."""
        series = self._series(name, COUNTER)
        if self._rollup_active and self._rollup.drop_label in labels:
            reduced = self._reduced(labels)
            rkey = _label_key(reduced)
            series[rkey] = series.get(rkey, 0.0) + value
            self._track_topk(name, rkey,
                             labels[self._rollup.drop_label], value)
            return
        key = _label_key(labels)
        series[key] = series.get(key, 0.0) + value

    def gauge(self, name: str, value, **labels) -> None:
        """Set the gauge at ``(name, labels)`` (last write wins).

        Under active rollup, device-labeled gauges become per-cell
        *distributions* (a bounded sketch at the device-stripped cell)
        instead of N last-write cells; round/cell-level gauges — the
        ``round.*`` fields backing :class:`RoundLog` — never carry a
        device label and are unaffected."""
        series = self._series(name, GAUGE)
        if self._rollup_active and self._rollup.drop_label in labels:
            rkey = _label_key(self._reduced(labels))
            self._sketch_cell(series, name, rkey).add(value)
            return
        series[_label_key(labels)] = value

    def observe(self, name: str, value, **labels) -> None:
        """Append one observation to the histogram at ``(name, labels)``.

        Device-labeled observations fold into bounded per-cell sketches
        under active rollup; otherwise the exact list path applies until
        the name's ``histogram_cap`` is crossed, at which point every
        cell folds into one overflow sketch (see module docstring)."""
        series = self._series(name, HISTOGRAM)
        if self._rollup_active and self._rollup.drop_label in labels:
            reduced = self._reduced(labels)
            rkey = _label_key(reduced)
            self._sketch_cell(series, name, rkey).add(value)
            self._track_topk(name, rkey,
                             labels[self._rollup.drop_label], value)
            return
        overflow = series.get(_OVERFLOW_CELL)
        if isinstance(overflow, QuantileSketch):
            overflow.add(value)
            return
        # repro: ignore[unbounded-telemetry] — the exact path is bounded
        # by histogram_cap: the conversion below folds the cells into a
        # fixed-size sketch the moment the per-name budget is crossed.
        series.setdefault(_label_key(labels), []).append(value)
        n = self._n_obs.get(name, 0) + 1
        self._n_obs[name] = n
        if n > self.histogram_cap:
            self._fold_into_overflow(name, series)

    def _fold_into_overflow(self, name: str, series: dict) -> None:
        """Replace every exact cell of ``name`` with one bounded sketch.

        Cells are drained in :meth:`records` order (sorted label keys,
        in-cell insertion order), so the fold — and everything derived
        from it — is a pure function of the emission sequence."""
        cap = (self._rollup.sketch_capacity if self._rollup
               else DEFAULT_SKETCH_CAPACITY)
        seed = self._rollup.seed if self._rollup else 0
        sk = QuantileSketch(cap, salt=f"{name}|overflow|{seed}")
        for key in sorted(series, key=lambda k: repr(k)):
            cell = series[key]
            if isinstance(cell, QuantileSketch):
                sk = sk.merge(cell)
            else:
                for v in cell:
                    sk.add(v)
        series.clear()
        series[_OVERFLOW_CELL] = sk

    # ------------------------------------------------------------- queries

    def kind(self, name: str) -> Optional[str]:
        return self._kinds.get(name)

    def value(self, name: str, **labels):
        """The stored value at exactly ``(name, labels)`` (None if absent).

        Gauges/counters return the scalar; histograms the observation
        list; rolled-up cells the :class:`QuantileSketch` itself."""
        series = self._metrics.get(name)
        if series is None:
            return None
        return series.get(_label_key(labels))

    def total(self, name: str, **labels) -> float:
        """Sum over every entry of ``name`` whose labels are a superset of
        the given filter (counters/gauges sum values; histograms sum
        observations; sketch cells contribute their exact ``sum``
        moment)."""
        out = 0.0
        for key, value in self._metrics.get(name, {}).items():
            have = dict(key)
            if all(have.get(k) == v for k, v in labels.items()):
                if isinstance(value, QuantileSketch):
                    out += value.sum
                elif isinstance(value, list):
                    out += sum(value)
                else:
                    out += value
        return out

    def summary(self, name: str, labels: Optional[dict] = None,
                quantiles: tuple = (0.5, 0.95, 0.99)) -> Optional[dict]:
        """Order statistics over a histogram's pooled observations.

        Pools every observation list of ``name`` whose labels are a
        superset of the ``labels`` filter (same matching rule as
        :meth:`total`), then returns ``{count, sum, min, max, mean,
        p<q>...}`` — quantiles via linear interpolation between closest
        ranks (numpy's default method, reimplemented so the registry
        stays dependency-free).  ``None`` when nothing matched or the
        metric holds neither observation lists nor sketch cells.

        When no sketch cells match, the computation is byte-for-byte the
        pre-sketch exact path (the small-run bitwise guard).  With
        sketch cells, ``count``/``sum``/``min``/``max`` use the sketches'
        exact moments and the quantiles interpolate over the pooled
        retained sample — within the sketches' declared rank error.
        """
        kind = self._kinds.get(name)
        labels = labels or {}
        obs: list[float] = []
        sketches: list[QuantileSketch] = []
        for key, values in self._metrics.get(name, {}).items():
            have = dict(key)
            if not all(have.get(k) == v for k, v in labels.items()):
                continue
            if isinstance(values, QuantileSketch):
                sketches.append(values)
            elif kind == HISTOGRAM:
                obs.extend(float(v) for v in values)
        if not obs and not sketches:
            return None
        for q in quantiles:
            if not 0.0 <= q <= 1.0:
                raise ValueError(f"quantile {q} outside [0, 1]")
        if not sketches:
            obs.sort()
            n = len(obs)
            out = {"count": n, "sum": sum(obs), "min": obs[0],
                   "max": obs[-1], "mean": sum(obs) / n}
            for q in quantiles:
                out[f"p{q * 100:g}"] = _interp(obs, q)
            return out
        count = len(obs) + sum(sk.count for sk in sketches)
        total = sum(obs) + sum(sk.sum for sk in sketches)
        lows = ([min(obs)] if obs else []) + [
            sk.min for sk in sketches if sk.min is not None]
        highs = ([max(obs)] if obs else []) + [
            sk.max for sk in sketches if sk.max is not None]
        sample = sorted(obs + [v for sk in sketches for v in sk.values()])
        out = {"count": count, "sum": total,
               "min": min(lows), "max": max(highs),
               "mean": total / count}
        for q in quantiles:
            out[f"p{q * 100:g}"] = _interp(sample, q)
        return out

    def top_devices(self, name: str, k: int = 8,
                    **labels) -> list[tuple[str, float]]:
        """Top-``k`` (device, value) heavy hitters of ``name`` across
        every cell whose labels are a superset of the filter — best
        first.

        Under rollup this merges the bounded :class:`TopK` trackers; on
        the exact path it pools the per-device cells (max observation
        per device), so the query works on any bundle."""
        matched = [self._topk[(n, key)]
                   for (n, key) in sorted(self._topk,
                                          key=lambda nk: repr(nk[1]))
                   if n == name and all(
                       dict(key).get(kk) == vv
                       for kk, vv in labels.items())]
        if matched:
            merged = matched[0]
            for tk in matched[1:]:
                merged = merged.merge(tk)
            return merged.items()[:k]
        drop = self._rollup.drop_label if self._rollup else "device"
        best: dict[str, float] = {}
        for cell_key, value in self._metrics.get(name, {}).items():
            have = dict(cell_key)
            if drop not in have:
                continue
            dev = str(have.pop(drop))
            if not all(have.get(kk) == vv for kk, vv in labels.items()):
                continue
            if isinstance(value, QuantileSketch):
                v = value.max
            elif isinstance(value, list):
                if not value:
                    continue
                v = max(float(x) for x in value)
            else:
                v = float(value)
            if v is None:
                continue
            if dev not in best or v > best[dev]:
                best[dev] = v
        ranked = sorted(best.items(), key=lambda kv: (-kv[1], kv[0]))
        return ranked[:k]

    def topk_cells(self) -> list[tuple[str, dict, "TopK"]]:
        """Every heavy-hitter tracker as ``(name, labels, TopK)``."""
        return [(name, dict(key), tk)
                for (name, key), tk in sorted(
                    self._topk.items(),
                    key=lambda item: (item[0][0], repr(item[0][1])))]

    def series(self, name: str, over: str, **labels) -> list[tuple]:
        """``[(label_value, value), ...]`` of ``name`` swept over the
        ``over`` label, filtered to entries matching ``labels`` exactly on
        the filter keys; sorted by the swept label value."""
        rows = []
        for key, value in self._metrics.get(name, {}).items():
            have = dict(key)
            if over not in have:
                continue
            if all(have.get(k) == v for k, v in labels.items()):
                rows.append((have[over], value))
        return sorted(rows, key=lambda kv: kv[0])

    def label_values(self, name: str, label: str) -> list:
        """Sorted distinct values the ``label`` dimension takes on
        ``name``."""
        vals = {dict(key)[label] for key in self._metrics.get(name, {})
                if label in dict(key)}
        return sorted(vals)

    def names(self) -> list[str]:
        return sorted(self._metrics)

    # -------------------------------------------------------------- export

    def records(self) -> Iterator[dict]:
        """One flat dict per stored entry (JSONL-ready, sorted by name
        then labels — deterministic across runs).  Sketch and top-k
        cells serialize as tagged docs that :meth:`from_records`
        re-hydrates bitwise."""
        for name in sorted(self._metrics):
            kind = self._kinds[name]
            for key in sorted(self._metrics[name],
                              key=lambda k: repr(k)):
                value = self._metrics[name][key]
                if isinstance(value, QuantileSketch):
                    value = value.to_dict()
                yield {"name": name, "kind": kind,
                       "labels": dict(key),
                       "value": value}
        for (name, key) in sorted(self._topk,
                                  key=lambda nk: (nk[0], repr(nk[1]))):
            yield {"name": name, "kind": TOPK_KIND, "labels": dict(key),
                   "value": self._topk[(name, key)].to_dict()}

    def to_jsonl(self, path: str) -> int:
        """Write every record as one JSON line; returns the line count."""
        n = 0
        with open(path, "w") as f:
            for rec in self.records():
                f.write(json.dumps(rec, default=_jsonable) + "\n")
                n += 1
        return n


def _interp(sorted_obs: list[float], q: float) -> float:
    """Linear interpolation between closest ranks (numpy default)."""
    n = len(sorted_obs)
    rank = q * (n - 1)
    lo = int(rank)
    hi = min(lo + 1, n - 1)
    frac = rank - lo
    return sorted_obs[lo] * (1.0 - frac) + sorted_obs[hi] * frac


def _jsonable(obj):
    """Fallback serializer: numpy scalars -> python, else repr."""
    item = getattr(obj, "item", None)
    if callable(item):
        try:
            return item()
        except Exception:
            pass
    return repr(obj)
