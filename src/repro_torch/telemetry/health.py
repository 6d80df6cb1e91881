"""Streaming health engine: rule-based detectors over ``learning.*``
and ``round.*`` series, evaluated once per round.

The engine is deliberately simple — a handful of declarative rules over
the metric series the recorder just wrote, no model of its own — because
its job is to *flag* rounds for a human (or the planned closed-loop
controller) to look at, not to adjudicate them.  Each firing produces an
alert record:

    {"round": int, "t": float, "rule": str, "kind": str,
     "severity": "warning"|"critical", "signal": str,
     "value": float, "threshold": float, "message": str}

which is (a) emitted as an ``ALERT`` instant into the trace (visible on
the Perfetto timeline next to the round spans), (b) appended to
``alerts.jsonl`` in the flush bundle, and (c) summarized in the
``[health]`` end-of-run table and the ``query health`` subcommand.

Detector kinds
--------------
``divergence_spike``
    ``learning.agg_update_norm`` jumps above ``factor`` x the trailing
    median of the last ``window`` rounds (needs ``min_rounds`` of
    history first).  Params: ``window=5, factor=3.0, min_rounds=3``.
``ef_residual_blowup``
    The summed per-cell ``learning.ef_residual_energy`` spikes the same
    way — the EF loop is no longer telescoping (moving sorted frame,
    saturating codec).  Params: ``window=5, factor=5.0, min_rounds=3``.
``silent_devices``
    ``learning.silent_fraction`` still above ``threshold`` after round
    ``min_round`` — a class of devices has never contributed.  Params:
    ``threshold=0.5, min_round=2``.
``staleness_inflation``
    ``round.mean_staleness`` exceeds both ``factor`` x its trailing
    median and the absolute floor ``min_value`` — merges are consuming
    ever-older updates.  Params: ``window=5, factor=2.0, min_value=1.0,
    min_rounds=3``.
``backhaul_saturation``
    ``round.latency_backhaul_s / round.latency_s`` above ``threshold``
    — the edge->cloud wire dominates the critical path.  Params:
    ``threshold=0.5``.

Custom rule files (``--health-rules``) are a JSON list of
``{"name", "kind", "severity"?, "params"?}`` objects; ``kind`` must be
one of the above, ``params`` overrides that detector's defaults.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Optional

__all__ = ["HealthRule", "HealthEngine", "DEFAULT_RULES", "load_rules",
           "ALERT_KEYS"]

# schema of one alerts.jsonl record (validate_telemetry checks this)
ALERT_KEYS = ("round", "t", "rule", "kind", "severity", "signal", "value",
              "threshold", "message")

_KIND_DEFAULTS = {
    "divergence_spike": {"window": 5, "factor": 3.0, "min_rounds": 3},
    "ef_residual_blowup": {"window": 5, "factor": 5.0, "min_rounds": 3},
    "silent_devices": {"threshold": 0.5, "min_round": 2},
    "staleness_inflation": {"window": 5, "factor": 2.0, "min_value": 1.0,
                            "min_rounds": 3},
    "backhaul_saturation": {"threshold": 0.5},
}


@dataclasses.dataclass(frozen=True)
class HealthRule:
    """One declarative detector instance."""
    name: str
    kind: str
    severity: str = "warning"
    params: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if self.kind not in _KIND_DEFAULTS:
            raise ValueError(
                f"unknown health rule kind {self.kind!r}; expected one of "
                f"{sorted(_KIND_DEFAULTS)}")
        if self.severity not in ("warning", "critical"):
            raise ValueError(
                f"rule {self.name!r}: severity must be 'warning' or "
                f"'critical', got {self.severity!r}")
        unknown = set(self.params) - set(_KIND_DEFAULTS[self.kind])
        if unknown:
            raise ValueError(
                f"rule {self.name!r}: unknown params {sorted(unknown)} "
                f"for kind {self.kind!r}")

    def param(self, key: str):
        return self.params.get(key, _KIND_DEFAULTS[self.kind][key])


DEFAULT_RULES = (
    HealthRule("divergence-spike", "divergence_spike"),
    HealthRule("ef-residual-blowup", "ef_residual_blowup"),
    HealthRule("silent-devices", "silent_devices"),
    HealthRule("staleness-inflation", "staleness_inflation"),
    HealthRule("backhaul-saturation", "backhaul_saturation"),
)


def load_rules(path: str) -> tuple:
    """Parse a ``--health-rules`` JSON file into rule instances."""
    with open(path) as f:
        raw = json.load(f)
    if not isinstance(raw, list):
        raise ValueError(f"{path}: expected a JSON list of rule objects")
    rules = []
    for i, obj in enumerate(raw):
        if not isinstance(obj, dict) or "name" not in obj or "kind" not in obj:
            raise ValueError(
                f"{path}: rule #{i} must be an object with 'name' and "
                f"'kind'")
        rules.append(HealthRule(
            name=obj["name"], kind=obj["kind"],
            severity=obj.get("severity", "warning"),
            params=obj.get("params", {})))
    return tuple(rules)


def _trailing_median(history: list) -> Optional[float]:
    if not history:
        return None
    s = sorted(history)
    n = len(s)
    mid = n // 2
    return s[mid] if n % 2 else 0.5 * (s[mid - 1] + s[mid])


class HealthEngine:
    """Evaluates its rules against the registry after every round.

    Stateful only in the cheapest way: one trailing-window list of
    floats per spike rule.  ``evaluate`` is called from the runner
    strictly under ``if tel.enabled``, after the round's metrics have
    been recorded, so every signal it reads is already in the registry.
    """

    def __init__(self, rules=DEFAULT_RULES):
        self.rules = tuple(rules)
        self._alerts: list[dict] = []
        self._history: dict[str, list] = {r.name: [] for r in self.rules}

    # ----------------------------------------------------------- signals

    @staticmethod
    def _signal(rule: HealthRule, round_idx: int, registry):
        """(signal_name, value) the rule watches this round, or None."""
        if rule.kind == "divergence_spike":
            v = registry.value("learning.agg_update_norm", round=round_idx)
            return ("learning.agg_update_norm", v)
        if rule.kind == "ef_residual_blowup":
            v = registry.total("learning.ef_residual_energy",
                               round=round_idx)
            return ("learning.ef_residual_energy",
                    v if v != 0.0 or registry.label_values(
                        "learning.ef_residual_energy", "cell") else None)
        if rule.kind == "silent_devices":
            v = registry.value("learning.silent_fraction", round=round_idx)
            return ("learning.silent_fraction", v)
        if rule.kind == "staleness_inflation":
            v = registry.value("round.mean_staleness", round=round_idx)
            return ("round.mean_staleness", v)
        if rule.kind == "backhaul_saturation":
            bh = registry.value("round.latency_backhaul_s", round=round_idx)
            lat = registry.value("round.latency_s", round=round_idx)
            if bh is None or lat is None or lat <= 0.0:
                return ("round.latency_backhaul_s", None)
            return ("round.latency_backhaul_s/round.latency_s", bh / lat)
        raise AssertionError(rule.kind)

    def _check(self, rule: HealthRule, round_idx: int, value: float
               ) -> Optional[tuple]:
        """(threshold, message) when the rule fires, else None.  Spike
        rules also push ``value`` into their trailing window."""
        if rule.kind in ("divergence_spike", "ef_residual_blowup",
                         "staleness_inflation"):
            hist = self._history[rule.name]
            med = _trailing_median(hist[-int(rule.param("window")):])
            hist.append(value)
            if len(hist) <= int(rule.param("min_rounds")) or med is None:
                return None
            threshold = rule.param("factor") * med
            if rule.kind == "staleness_inflation":
                threshold = max(threshold, rule.param("min_value"))
            if med > 0.0 and value > threshold:
                return (threshold,
                        f"{value:.4g} > {rule.param('factor')}x trailing "
                        f"median {med:.4g}")
            return None
        if rule.kind == "silent_devices":
            if (round_idx >= int(rule.param("min_round"))
                    and value > rule.param("threshold")):
                return (rule.param("threshold"),
                        f"{value:.0%} of the fleet has never contributed")
            return None
        if rule.kind == "backhaul_saturation":
            if value > rule.param("threshold"):
                return (rule.param("threshold"),
                        f"backhaul is {value:.0%} of round latency")
            return None
        raise AssertionError(rule.kind)

    # ---------------------------------------------------------- evaluate

    def evaluate(self, round_idx: int, t_wall: float, registry, tel) -> None:
        """Run every rule against round ``round_idx``'s metrics."""
        for rule in self.rules:
            signal, value = self._signal(rule, round_idx, registry)
            if value is None:
                continue
            fired = self._check(rule, round_idx, float(value))
            if fired is None:
                continue
            threshold, message = fired
            alert = {"round": round_idx, "t": float(t_wall),
                     "rule": rule.name, "kind": rule.kind,
                     "severity": rule.severity, "signal": signal,
                     "value": float(value), "threshold": float(threshold),
                     "message": message}
            self._alerts.append(alert)
            tel.instant("health", "ALERT", t_wall, rule=rule.name,
                        kind=rule.kind, severity=rule.severity,
                        round=round_idx, value=float(value),
                        message=message)

    # ----------------------------------------------------------- outputs

    def alerts(self) -> list[dict]:
        return list(self._alerts)

    def to_jsonl(self, path) -> None:
        with open(path, "w") as f:
            for a in self._alerts:
                f.write(json.dumps(a) + "\n")

    def summary_table(self) -> list[str]:
        """``[health]`` end-of-run lines (one per rule that fired)."""
        if not self._alerts:
            return ["[health] 0 alerts"]
        lines = [f"[health] {len(self._alerts)} alert(s)"]
        by_rule: dict[str, list] = {}
        for a in self._alerts:
            # repro: ignore[unbounded-telemetry] — end-of-run regroup of
            # the already-materialized alert list, keyed by rule id (a
            # handful of values), not by a device-cardinality label
            by_rule.setdefault(a["rule"], []).append(a)
        width = max(len(r) for r in by_rule)
        for rule, hits in sorted(by_rule.items()):
            worst = max(hits, key=lambda a: a["value"] / a["threshold"]
                        if a["threshold"] else a["value"])
            rounds = ",".join(str(a["round"]) for a in hits[:6])
            more = "…" if len(hits) > 6 else ""
            lines.append(
                f"[health]   {rule:<{width}}  x{len(hits):<3d} "
                f"({hits[0]['severity']})  rounds [{rounds}{more}]  "
                f"worst r{worst['round']}: {worst['message']}")
        return lines
