"""Rule registry: the invariant pack for the PyTorch port, the
reference's six rules restated for its contracts.

Each rule is a :class:`Rule` wrapping a check function.  ``scope`` is
``"file"`` (called once per parsed :class:`~repro_torch.analysis.engine.
SourceFile`) or ``"project"`` (called once with the whole scanned set —
needed for cross-file contracts).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.analysis.rules import (
    entry_signature,
    inplace,
    kernel_oracle,
    randomness,
    telemetry_guard,
    unbounded,
)


@dataclasses.dataclass(frozen=True)
class Rule:
    id: str
    scope: str                  # "file" | "project"
    description: str
    _fn: Callable = dataclasses.field(repr=False)

    def check(self, src):
        return self._fn(src)

    def check_project(self, files):
        return self._fn(files)


ALL_RULES: tuple[Rule, ...] = (
    Rule(inplace.RULE_ID, "file",
         "no plain alias of a buffer read after an in-place entry mutates "
         "it",
         inplace.check),
    Rule(entry_signature.RULE_ID, "project",
         "build.Entry argtypes and launches match the extern \"C\" entry",
         entry_signature.check_project),
    Rule(randomness.RULE_ID, "file",
         "all randomness from seeded generators; no wall-clock reads",
         randomness.check),
    Rule(telemetry_guard.RULE_ID, "file",
         "telemetry calls guarded by tel.enabled; learning imported "
         "lazily",
         telemetry_guard.check),
    Rule(kernel_oracle.RULE_ID, "project",
         "every CUDA kernel has a ref.py plain version + a gpu test",
         kernel_oracle.check_project),
    Rule(unbounded.RULE_ID, "file",
         "no label-keyed list aggregation in telemetry/ — bounded "
         "sketches only",
         unbounded.check),
)

RULES_BY_ID = {r.id: r for r in ALL_RULES}
