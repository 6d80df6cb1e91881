"""One telemetry session per run: registry + trace sink + flush-to-disk.

``Telemetry(out_dir=...)`` is the live session the orchestrator emits
into; :data:`NULL_TELEMETRY` is the disabled singleton — every method a
no-op, ``enabled`` False so hot loops can skip even building the event
arguments (``if tel.enabled: tel.span(...)``).  The disabled path is
the default everywhere and is *bitwise-invisible*: neither the session
nor the registry ever touches an RNG stream or a tensor, and a
``None``/NULL session emits nothing at all.

``flush()`` writes the on-disk bundle next to a run::

    <out_dir>/trace.perfetto.json   load in ui.perfetto.dev
    <out_dir>/trace.jsonl           spans/instants, one JSON per line
    <out_dir>/metrics.jsonl         registry records, one JSON per line
    <out_dir>/manifest.json         provenance (see manifest.py)
    <out_dir>/alerts.jsonl          health alerts (only when a
                                    HealthEngine is attached via
                                    ``tel.health``; see health.py)
"""
from __future__ import annotations

import os
from typing import Optional

from repro_torch.telemetry.manifest import write_manifest
from repro_torch.telemetry.registry import MetricsRegistry
from repro_torch.telemetry.trace import TraceSink


class Telemetry:
    """Enabled session: delegates to a registry and a trace sink."""

    enabled = True

    def __init__(self, out_dir: Optional[str] = None, *,
                 torch_profile: bool = False, rollup=None,
                 trace_sample: Optional[float] = None,
                 trace_seed: int = 0):
        if torch_profile and out_dir is None:
            raise ValueError("torch_profile needs an out_dir: the profile "
                             "is written under <out_dir>/torch_profile")
        self.out_dir = out_dir
        self.torch_profile = torch_profile
        # fleet-scale bounds (both off by default — exact telemetry):
        # `rollup` is a RollupPolicy folding device-labeled metrics into
        # per-cell sketches once the registry's set_fleet_size crosses
        # its threshold;
        # `trace_sample` keeps only the deterministic blake2b hash-slice
        # of device/<id> trace rows (see sampling.py).
        self.registry = MetricsRegistry(rollup=rollup)
        sampler = None
        if trace_sample is not None:
            from repro_torch.telemetry.sampling import TraceSampler
            sampler = TraceSampler(trace_sample, seed=trace_seed)
        self.sink = TraceSink(sampler=sampler)
        # optional HealthEngine; attached by the launcher under --health
        # (kept an attribute, not a constructor arg, so the session never
        # imports the health module unless a run opts in)
        self.health = None

    def set_fleet_size(self, n: int) -> None:
        """Report the fleet size (engages rollup past its threshold).

        Pure bookkeeping — records nothing, so it is safe unguarded."""
        self.registry.set_fleet_size(n)

    # ------------------------------------------------ emission (delegates)

    def span(self, track: str, name: str, t0: float, t1: float,
             **args) -> None:
        self.sink.span(track, name, t0, t1, **args)

    def instant(self, track: str, name: str, t: float, **args) -> None:
        self.sink.instant(track, name, t, **args)

    def counter(self, name: str, value: float = 1.0, **labels) -> None:
        self.registry.counter(name, value, **labels)

    def gauge(self, name: str, value, **labels) -> None:
        self.registry.gauge(name, value, **labels)

    def observe(self, name: str, value, **labels) -> None:
        self.registry.observe(name, value, **labels)

    # --------------------------------------------------------------- flush

    def flush(self, manifest: Optional[dict] = None,
              out_dir: Optional[str] = None) -> dict:
        """Write the telemetry bundle; returns ``{artifact: path}``."""
        out_dir = out_dir or self.out_dir
        if out_dir is None:
            raise ValueError("Telemetry.flush needs an out_dir (pass one "
                             "here or at construction)")
        os.makedirs(out_dir, exist_ok=True)
        paths = {}
        perfetto = os.path.join(out_dir, "trace.perfetto.json")
        self.sink.write_perfetto(perfetto)
        paths["perfetto"] = perfetto
        jsonl = os.path.join(out_dir, "trace.jsonl")
        self.sink.write_jsonl(jsonl)
        paths["trace_jsonl"] = jsonl
        metrics = os.path.join(out_dir, "metrics.jsonl")
        self.registry.to_jsonl(metrics)
        paths["metrics_jsonl"] = metrics
        if self.health is not None:
            alerts = os.path.join(out_dir, "alerts.jsonl")
            self.health.to_jsonl(alerts)
            paths["alerts_jsonl"] = alerts
        if manifest is not None:
            paths["manifest"] = write_manifest(
                os.path.join(out_dir, "manifest.json"), manifest)
        return paths


class _NullTelemetry:
    """Disabled session: every emission a no-op, nothing allocated."""

    enabled = False
    out_dir = None
    torch_profile = False
    registry = None
    sink = None
    health = None

    def set_fleet_size(self, n):
        pass

    def span(self, track, name, t0, t1, **args):
        pass

    def instant(self, track, name, t, **args):
        pass

    def counter(self, name, value=1.0, **labels):
        pass

    def gauge(self, name, value, **labels):
        pass

    def observe(self, name, value, **labels):
        pass

    def flush(self, manifest=None, out_dir=None):
        return {}


NULL_TELEMETRY = _NullTelemetry()
