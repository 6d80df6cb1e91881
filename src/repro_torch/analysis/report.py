"""Reporters: human text and machine JSON renderings of a finding list."""
from __future__ import annotations

import json
from collections import Counter
from typing import Optional

from repro_torch.analysis.engine import Finding


def render_text(findings: list[Finding], *, grandfathered: int = 0,
                stale: Optional[Counter] = None,
                n_files: int = 0) -> str:
    lines = []
    for f in findings:
        lines.append(f"{f.file}:{f.line}: [{f.rule}] {f.message}")
    by_rule = Counter(f.rule for f in findings)
    if findings:
        summary = ", ".join(f"{rid}: {n}"
                            for rid, n in sorted(by_rule.items()))
        lines.append(f"-- {len(findings)} finding(s) in {n_files} "
                     f"file(s) ({summary})")
    else:
        lines.append(f"-- clean: 0 findings in {n_files} file(s)")
    if grandfathered:
        lines.append(f"-- {grandfathered} grandfathered finding(s) "
                     f"covered by the baseline")
    if stale:
        lines.append(f"-- {sum(stale.values())} stale baseline entr"
                     f"{'y' if sum(stale.values()) == 1 else 'ies'} "
                     f"(fixed — re-run with --write-baseline to tighten):")
        for (file, rule, _msg), n in sorted(stale.items()):
            lines.append(f"   {file} [{rule}] x{n}")
    return "\n".join(lines)


def render_json(findings: list[Finding], *, grandfathered: int = 0,
                stale: Optional[Counter] = None,
                n_files: int = 0) -> str:
    payload = {
        "findings": [f.to_dict() for f in findings],
        "counts": dict(Counter(f.rule for f in findings)),
        "n_files": n_files,
        "grandfathered": grandfathered,
        "stale_baseline": [
            {"file": file, "rule": rule, "message": msg, "count": n}
            for (file, rule, msg), n in sorted((stale or Counter())
                                               .items())],
    }
    return json.dumps(payload, indent=1, sort_keys=True)
