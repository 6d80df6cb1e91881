"""CLI: ``python -m repro_torch.analysis [--format json] [--baseline]
[paths]``.

Exit codes: 0 = no unbaselined findings; 1 = new findings (or stale
baseline entries under ``--strict-baseline``); 2 = usage error.
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.analysis.baseline import (
    DEFAULT_BASELINE,
    apply_baseline,
    load_baseline,
    save_baseline,
)
from repro_torch.analysis.engine import collect_files, run_analysis
from repro_torch.analysis.report import render_json, render_text
from repro_torch.analysis.rules import ALL_RULES


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="AST-based invariant checker of the PyTorch port: "
                    "in-place, entry, determinism and telemetry contracts")
    p.add_argument("paths", nargs="*", default=None,
                   help="files/directories to scan "
                        "(default: src/repro_torch)")
    p.add_argument("--format", choices=("text", "json"), default="text")
    p.add_argument("--baseline", nargs="?", const=DEFAULT_BASELINE,
                   default=None, metavar="PATH",
                   help=f"grandfather findings listed in PATH "
                        f"(default: {DEFAULT_BASELINE})")
    p.add_argument("--write-baseline", nargs="?", const=DEFAULT_BASELINE,
                   default=None, metavar="PATH",
                   help="snapshot current findings as the new baseline "
                        "and exit 0")
    p.add_argument("--strict-baseline", action="store_true",
                   help="also fail when the baseline has stale entries")
    p.add_argument("--rule", action="append", default=None,
                   metavar="RULE-ID",
                   help="run only the named rule(s)")
    p.add_argument("--list-rules", action="store_true")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.list_rules:
        for rule in ALL_RULES:
            print(f"{rule.id:>24s}  [{rule.scope}]  {rule.description}")
        return 0

    rules = ALL_RULES
    if args.rule:
        known = {r.id: r for r in ALL_RULES}
        bad = [rid for rid in args.rule if rid not in known]
        if bad:
            print(f"unknown rule(s): {', '.join(bad)} "
                  f"(see --list-rules)", file=sys.stderr)
            return 2
        rules = [known[rid] for rid in args.rule]

    paths = args.paths or ["src/repro_torch"]
    findings = run_analysis(paths, rules=rules)
    n_files = len(collect_files(paths))

    if args.write_baseline is not None:
        save_baseline(args.write_baseline, findings)
        print(f"wrote {len(findings)} finding(s) to "
              f"{args.write_baseline}")
        return 0

    grandfathered, stale = 0, None
    if args.baseline is not None:
        try:
            base = load_baseline(args.baseline)
        except FileNotFoundError:
            print(f"baseline {args.baseline} not found "
                  f"(run --write-baseline first)", file=sys.stderr)
            return 2
        findings, old, stale = apply_baseline(findings, base)
        grandfathered = len(old)

    render = render_json if args.format == "json" else render_text
    print(render(findings, grandfathered=grandfathered, stale=stale,
                 n_files=n_files))
    if findings:
        return 1
    if args.strict_baseline and stale:
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
