"""The readings a cell's comparison limits are set from, on the card.

    python3 flbench/readings.py --workload <cell> --seeds 1 2 ... \
        [--control-seeds 1 2 3] [--faults half_batch ...] \
        [--out chiprun_out/readings.jsonl]

For each ``--seeds`` seed: the program through the cell's checked rounds
(as a run's set-up drives them) against the plain reference, the lower
readings.  For each ``--control-seeds`` seed: the program module's
``control`` (the reference in a lower precision put in the program's
place) and its ``fault(name, ...)`` for each of ``--faults``, against
the reference: the upper readings.  One JSON line a reading.  The
benchmark's runs never run this.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))


def readings(workload: str, seeds=(), control_seeds=(), faults=(), *,
             device: str = "cuda", overrides: dict | None = None):
    """Yield one reading a side and seed: ``{"workload", "kind", "seed",
    "numbers", "seconds"}``; ``kind`` is ``program``, ``control`` or
    ``fault_<name>``."""
    import run
    sys.path.insert(0, str(run.ROOT / "src"))
    import torch

    _, _, config, traffic, cell = run.load_cell(workload, overrides)
    mod = run.program_module(config)

    def free():
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()

    def reading(kind, seed, side):
        t0 = time.perf_counter()
        cap = side()
        t1 = time.perf_counter()
        free()
        nums = mod.follow(config, traffic, cell, seed, device, cap)
        del cap
        free()
        return {"workload": workload, "kind": kind, "seed": seed,
                "numbers": nums,
                "seconds": {"side": t1 - t0,
                            "reference": time.perf_counter() - t1}}

    def program(seed):
        prog = mod.build(config, traffic, cell, seed, device)
        try:
            prog.checked()
            return prog.release()
        finally:
            getattr(prog, "close", lambda: None)()

    for seed in seeds:
        yield reading("program", seed, lambda: program(seed))
    for seed in control_seeds:
        yield reading("control", seed, lambda: mod.control(
            config, traffic, cell, seed, device))
        for name in faults:
            yield reading(f"fault_{name}", seed, lambda: mod.fault(
                name, config, traffic, cell, seed, device))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--faults", nargs="*", default=[])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    out = open(args.out, "a") if args.out else None
    for r in readings(args.workload, args.seeds, args.control_seeds,
                      args.faults):
        line = json.dumps(r)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
