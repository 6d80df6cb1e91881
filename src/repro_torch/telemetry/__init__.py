"""Observability layer: metrics registry, structured tracing, manifests.

The sensors of the AnycostFL pipeline.  One :class:`Telemetry` session
per run collects (1) a label-keyed :class:`MetricsRegistry` — counters/
gauges/histograms over ``device`` / ``cell`` / ``phase`` / ``round``
dimensions, also the backing store of every ``RoundLog`` — and (2) a
:class:`TraceSink` turning the simulated discrete-event timeline into
spans and instants exportable as Perfetto/Chrome-trace JSON and JSONL.
:mod:`~repro_torch.telemetry.manifest` stamps artifacts with full provenance
(config, seeds, versions, git sha, trace-signature hash);
:mod:`~repro_torch.telemetry.profiler` optionally wraps a run in
``torch.profiler`` for kernel-level device timing.

The learning-dynamics layer sits on top: :mod:`~repro_torch.telemetry.
learning` (streaming update-norm / compression-error / contribution
diagnostics — imported lazily by the orchestrator, only when a session
is enabled, so the disabled path stays allocation-free) and
:mod:`~repro_torch.telemetry.health` (a rule-based :class:`HealthEngine`
evaluating those series each round into ``ALERT`` trace instants and an
``alerts.jsonl`` in the flush bundle).

Disabled (the default) telemetry is :data:`NULL_TELEMETRY`: zero-cost
no-ops, bitwise-invisible to the seeded simulation.
"""
from repro_torch.telemetry.health import (ALERT_KEYS, DEFAULT_RULES,
                                    HealthEngine, HealthRule, load_rules)
from repro_torch.telemetry.manifest import (COMPARABLE_KEYS, REQUIRED_KEYS,
                                      build_manifest, manifest_mismatches,
                                      to_jsonable, trace_signature_hash,
                                      validate_manifest, write_manifest)
from repro_torch.telemetry.profiler import profile_trace
from repro_torch.telemetry.references import (DIRECTIONS, EXACT, FAIL, HIGHER,
                                        LOWER, PASS, SKIP, Reference,
                                        Verdict, check_record,
                                        check_reference, extract_path)
from repro_torch.telemetry.registry import (COUNTER, GAUGE, HISTOGRAM,
                                      MetricsRegistry)
from repro_torch.telemetry.sampling import TraceSampler, sampled
from repro_torch.telemetry.session import NULL_TELEMETRY, Telemetry
from repro_torch.telemetry.sketch import (QuantileSketch, RollupPolicy, TopK,
                                    bottom_k, hash01)
from repro_torch.telemetry.trace import Instant, Span, TraceSink

__all__ = [
    "COUNTER", "GAUGE", "HISTOGRAM", "MetricsRegistry",
    "TraceSink", "Span", "Instant",
    "Telemetry", "NULL_TELEMETRY",
    "QuantileSketch", "TopK", "RollupPolicy", "bottom_k", "hash01",
    "TraceSampler", "sampled",
    "build_manifest", "write_manifest", "validate_manifest",
    "manifest_mismatches", "COMPARABLE_KEYS",
    "to_jsonable", "trace_signature_hash", "REQUIRED_KEYS",
    "profile_trace",
    "Reference", "Verdict", "check_reference", "check_record",
    "extract_path", "DIRECTIONS", "LOWER", "HIGHER", "EXACT",
    "PASS", "FAIL", "SKIP",
    "HealthEngine", "HealthRule", "DEFAULT_RULES", "load_rules",
    "ALERT_KEYS",
]
