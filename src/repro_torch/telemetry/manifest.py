"""Run manifests: make every artifact a comparable data point.

A perf JSON without its provenance is a snapshot; with a manifest next
to it (or embedded in it) it becomes one point on a trajectory that a
regression harness can diff: *what* ran (full config dataclasses,
seeds), *on what* (torch/CUDA/numpy versions, backend, device count,
platform), *from which code* (git sha, dirty flag), and *what timeline
it produced* (a stable hash of the event-trace signature, so two
"identical" runs can be checked for bitwise replay without shipping the
full trace).

``build_manifest`` never raises on missing context (no git, no CUDA
build): absent facts record as ``None`` rather than failing
a benchmark run.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import platform
import subprocess
import sys
import time
from typing import Any, Optional

import numpy
import torch

MANIFEST_SCHEMA = 1

# keys every manifest carries (validate_manifest checks them)
REQUIRED_KEYS = ("schema", "created_at", "torch", "cuda", "numpy",
                 "python", "backend", "git_sha", "config",
                 "trace_signature_hash")


def _git_sha() -> Optional[str]:
    here = os.path.dirname(os.path.abspath(__file__))
    try:
        out = subprocess.run(["git", "rev-parse", "HEAD"], cwd=here,
                             capture_output=True, text=True, timeout=10)
        if out.returncode == 0:
            return out.stdout.strip()
    except Exception:
        pass
    return None


def _git_dirty() -> Optional[bool]:
    here = os.path.dirname(os.path.abspath(__file__))
    try:
        out = subprocess.run(["git", "status", "--porcelain"], cwd=here,
                             capture_output=True, text=True, timeout=10)
        if out.returncode == 0:
            return bool(out.stdout.strip())
    except Exception:
        pass
    return None


def to_jsonable(obj: Any):
    """Recursively reduce configs to JSON-safe structures.

    Dataclasses become dicts, tuples become lists, numpy scalars become
    python scalars, and anything else falls back to ``repr`` — a
    manifest must never fail to serialize because a config grew a field.
    """
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: to_jsonable(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, dict):
        return {str(k): to_jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [to_jsonable(v) for v in obj]
    if isinstance(obj, (str, int, float, bool, type(None))):
        return obj
    item = getattr(obj, "item", None)
    if callable(item):
        try:
            return item()
        except Exception:
            pass
    return repr(obj)


def trace_signature_hash(signature) -> Optional[str]:
    """Stable 128-bit hex digest of an event-trace signature (the tuple
    from ``EventQueue.trace_signature`` — full or rolling form)."""
    if signature is None:
        return None
    h = hashlib.blake2b(digest_size=16)
    h.update(repr(signature).encode())
    return h.hexdigest()


def build_manifest(run_cfg=None, fleet_cfg=None, orch=None, *, device,
                   trace_signature=None, extra: Optional[dict] = None
                   ) -> dict:
    """Assemble the provenance record for one run/artifact; ``backend``
    is the type of ``device``, the device the run used (``"cuda"`` or
    ``"cpu"``)."""
    manifest = {
        "schema": MANIFEST_SCHEMA,
        "created_at": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "argv": list(sys.argv),
        "python": platform.python_version(),
        "platform": platform.platform(),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "numpy": numpy.__version__,
        "backend": torch.device(device).type,
        "n_devices": torch.cuda.device_count(),
        "git_sha": _git_sha(),
        "git_dirty": _git_dirty(),
        "config": {
            "run": to_jsonable(run_cfg) if run_cfg is not None else None,
            "fleet": to_jsonable(fleet_cfg)
            if fleet_cfg is not None else None,
            "orchestrator": to_jsonable(orch) if orch is not None else None,
        },
        "seeds": _collect_seeds(run_cfg, fleet_cfg),
        "trace_signature_hash": trace_signature_hash(trace_signature),
    }
    if extra:
        manifest["extra"] = to_jsonable(extra)
    return manifest


def _collect_seeds(run_cfg, fleet_cfg) -> dict:
    seeds = {}
    if run_cfg is not None and hasattr(run_cfg, "seed"):
        seeds["run"] = run_cfg.seed
    dyn = getattr(fleet_cfg, "dynamics", None)
    if dyn is not None:
        seeds["selection"] = getattr(dyn, "selection_seed", None)
        avail = getattr(dyn, "availability", None)
        if avail is not None:
            seeds["availability"] = getattr(avail, "seed", None)
    mob = getattr(fleet_cfg, "mobility", None)
    if mob is not None:
        seeds["mobility"] = getattr(mob, "seed", None)
    return seeds


#: manifest keys that must agree for two bundles to be comparable —
#: anything differing here means a `query diff` compares apples to
#: oranges (different code, config, seeds, or numeric stack)
COMPARABLE_KEYS = ("schema", "config", "seeds", "torch", "cuda",
                   "numpy", "python", "backend", "git_sha")


def manifest_mismatches(a: Optional[dict], b: Optional[dict],
                        keys: tuple = COMPARABLE_KEYS) -> list[str]:
    """Human-readable ``"key: a=... b=..."`` lines for every comparable
    key on which two manifests disagree (empty list = aligned).  A
    missing manifest mismatches on every key."""
    out = []
    a = a if isinstance(a, dict) else {}
    b = b if isinstance(b, dict) else {}
    for key in keys:
        va, vb = a.get(key), b.get(key)
        if va == vb:
            continue
        if key == "config" and isinstance(va, dict) \
                and isinstance(vb, dict):
            inner = sorted(set(va) | set(vb))
            diff = [k for k in inner if va.get(k) != vb.get(k)]
            out.append(f"config: sections differ: {', '.join(diff)}")
            continue
        out.append(f"{key}: a={_short(va)} b={_short(vb)}")
    return out


def _short(v, limit: int = 60) -> str:
    s = json.dumps(v, default=repr) if isinstance(v, (dict, list)) \
        else repr(v)
    return s if len(s) <= limit else s[:limit - 3] + "..."


def validate_manifest(manifest: dict) -> list[str]:
    """Missing required keys (empty list = valid)."""
    if not isinstance(manifest, dict):
        return list(REQUIRED_KEYS)
    return [k for k in REQUIRED_KEYS if k not in manifest]


def write_manifest(path: str, manifest: dict) -> str:
    """Write to ``path`` (a ``manifest.json`` inside it if a directory)."""
    if os.path.isdir(path):
        path = os.path.join(path, "manifest.json")
    with open(path, "w") as f:
        json.dump(manifest, f, indent=1, default=repr)
    return path
