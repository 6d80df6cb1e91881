"""repro_torch.analysis — the AST invariant checker for the PyTorch port.

The counterpart of ``repro/analysis``: the same engine, reports,
baselines and ``# repro: ignore[rule-id]`` suppressions, and the
reference's six rules restated for the port's contracts:

* **read-after-inplace** (the reference's use-after-donate) — the port's
  in-place entries (``aio_absorb`` / ``aio_merge``, ``absorb_trees`` /
  ``merge_trees``, ``partial_absorb`` / ``partial_merge``,
  ``Optimizer.update``, the compressed gradient sync) write into their
  operands; a plain alias taken before such a call and read after it
  silently holds the new values.
* **entry-signature** (the reference's io-alias-consistency) — every
  ``build.Entry`` matches its ``extern "C"`` entry in ``kernels/csrc``:
  argtypes, launch arity, and which pointers the kernel writes.
* **unseeded-randomness** — every draw from a seeded
  ``torch.Generator`` (``generator=``) or
  ``np.random.default_rng([seed, ...])``; no global torch, numpy or
  stdlib RNG, no wall-clock reads outside telemetry.
* **unguarded-telemetry** — telemetry calls in the orchestration layers
  dominated by ``if tel.enabled:``; ``repro_torch.telemetry.learning``
  imported lazily.
* **kernel-oracle-pairing** — every exported CUDA kernel has a plain
  version in ``kernels/ref.py`` and a card test (marked ``gpu``).
* **unbounded-telemetry** — no label-keyed list aggregation in
  ``telemetry/``.

It needs only ``ast`` and ``re``: neither torch nor JAX.  Run it as a
CLI::

    python -m repro_torch.analysis [--format json] [--baseline [PATH]]
        [paths...]
"""
from repro_torch.analysis.engine import (
    Finding,
    SourceFile,
    collect_files,
    run_analysis,
)
from repro_torch.analysis.rules import ALL_RULES

__all__ = [
    "Finding",
    "SourceFile",
    "collect_files",
    "run_analysis",
    "ALL_RULES",
]
