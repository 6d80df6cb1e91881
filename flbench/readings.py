"""The readings the comparison's limits are set from, on the chip.

    python3 flbench/readings.py --workload <cell> --seeds 1 2 ... \
        [--control-seeds 1 2 3] [--faults half_batch altered] \
        [--out chiprun_out/readings.jsonl]

For each ``--seeds`` seed: the program through the cell's checked rounds
(as a run's set-up drives them) against the float32 reference, the
lower readings.  For each ``--control-seeds`` seed: the reference in
TF32 put in the program's place (the control), and the reference with
each planted fault, against the float32 reference, the upper readings.
One JSON line a reading.  The benchmark's runs never run this.
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--faults", nargs="*", default=[])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import run
    sys.path.insert(0, str(run.ROOT / "src"))
    import torch

    from bench import check, inputs, program
    from reference import fl as ref_fl, model as ref_model

    _, _, config, traffic, cell = run.load_cell(args.workload)
    n_rounds = cell["check"]["rounds"]
    per_width = cell["check"]["per_width"]
    dev = "cuda"
    out = open(args.out, "a") if args.out else None

    def emit(kind, seed, nums, secs):
        line = json.dumps({"workload": args.workload, "kind": kind,
                           "seed": seed, "seconds": secs, "numbers": nums})
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    def judge(seed, cap):
        t0 = time.perf_counter()
        nums = ref_fl.follow(config, traffic, seed,
                             inputs.SeededUniforms(seed, dev), dev, cap,
                             n_rounds)
        return nums, time.perf_counter() - t0

    def stand_in(seed, sample, **kw):
        cap = check.Capture()
        t0 = time.perf_counter()
        ref_fl.simulate(config, traffic, seed,
                        inputs.SeededUniforms(seed, dev), dev, n_rounds,
                        cap, sample=sample, per_width=per_width, **kw)
        return cap, time.perf_counter() - t0

    for seed in sorted(set(args.seeds) | set(args.control_seeds)):
        sample = inputs.sample_devices(seed, config["fleet"]["n_devices"],
                                       cell["check"]["sample"])
        if seed in args.seeds:
            t0 = time.perf_counter()
            prog = program.Program(*program.build(
                config, traffic, seed, inputs.SeededUniforms(seed, dev),
                dev))
            numels = [x.numel() for x in ref_model.leaves(prog.sim.params)]
            cap = check.Capture()
            rec = check.ProgramRecorder(cap, sample, numels)
            with program.Hooks(prog, observe=rec), \
                    check.StepTap(prog, cap, seed, per_width) as tap:
                for t in range(n_rounds):
                    rec.t = tap.t = t
                    prog.round()
            t_prog = time.perf_counter() - t0
            del prog, rec, tap
            gc.collect()
            torch.cuda.empty_cache()
            nums, t_ref = judge(seed, cap)
            emit("program", seed, nums, {"program": t_prog,
                                         "reference": t_ref})
        if seed in args.control_seeds:
            runs = [("control_tf32", {"mode": "tf32"})] + [
                (f"fault_{f}", {"fault": f}) for f in args.faults]
            for kind, kw in runs:
                cap, t_run = stand_in(seed, sample, **kw)
                nums, t_ref = judge(seed, cap)
                emit(kind, seed, nums, {"stand_in": t_run,
                                        "reference": t_ref})
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
