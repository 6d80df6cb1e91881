"""Dry-run of a step at production mesh size, on ``meta`` tensors: no card
and no data.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2-7b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all              # every assigned pair
  python -m repro_torch.launch.dryrun --all --mesh multi # the 512-rank pass

As the reference's dry-run (``repro/launch/dryrun.py``) lowers and
compiles each (arch x input shape x mesh) on 512 host devices, this one
joins a fake process group (``torch.testing``'s ``FakeStore``; every
collective returns at once and moves nothing) of 256 ranks, or 512 for
``--mesh multi``, as rank 0, makes the production mesh over it, builds
the step with ``launch/steps.make_step_and_args`` under
``use_sharding(mesh, rules_for(...))`` and traces it once on ``meta``
``DTensor``s under the collective recorder and the flop counter
(``launch/roofline.trace_counts``).  Each result has the reference's
schema: ``lower_s`` is the trace's seconds and ``compile_s`` 0;
``memory_analysis``'s ``argument_size_in_bytes`` and
``output_size_in_bytes`` are rank 0's local shard bytes, its other
fields None; ``cost_analysis.flops`` is the trace's per-rank count and
``bytes_accessed`` None.  Results go to ``experiments/dryrun_torch/``;
a pair that fails prints ``[FAIL]`` and the run exits non-zero.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback

import torch

from repro_torch import sharding as shd
from repro_torch.configs import (ASSIGNED_ARCHS, INPUT_SHAPES, get_config,
                                 get_shape)
from repro_torch.launch import roofline as rl
from repro_torch.launch.mesh import describe, make_production_mesh
from repro_torch.launch.steps import make_step_and_args, rules_for
from repro_torch.models.registry import build_model
from repro_torch.train.optimizer import adamw
from repro_torch.utils.pytree import tree_leaves

OUT_DIR = "experiments/dryrun_torch"

# long_500k needs sub-quadratic attention: native for ssm / hybrid;
# dense/moe/vlm run their sliding-window variant; encdec skips.
SLIDING_WINDOW_FOR_LONG = 4096

MEMORY_FIELDS = ("argument_size_in_bytes", "output_size_in_bytes",
                 "temp_size_in_bytes", "generated_code_size_in_bytes",
                 "alias_size_in_bytes")


def plan_entry(arch: str, shape_name: str):
    """Returns (cfg, shape, note) or None if the pair is skipped."""
    cfg = get_config(arch)
    shape = get_shape(shape_name)
    note = ""
    if shape_name == "long_500k":
        if cfg.family == "encdec":
            return None  # full cross+self attention; out of domain
        if cfg.family in ("dense", "moe", "vlm"):
            cfg = dataclasses.replace(cfg,
                                      sliding_window=SLIDING_WINDOW_FOR_LONG)
            note = f"sliding_window={SLIDING_WINDOW_FOR_LONG} variant"
    return cfg, shape, note


def fake_group(world: int) -> None:
    """Join a fake process group of ``world`` ranks as rank 0 (once a
    process; a group of another size raises)."""
    dist = torch.distributed
    if dist.is_initialized():
        if dist.get_world_size() != world:
            raise RuntimeError(f"a process group of {dist.get_world_size()} "
                               f"ranks is initialised; this mesh needs "
                               f"{world}")
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def local_bytes(tree, shardings=None) -> int:
    """Rank 0's bytes of the tensors of a tree (or a tuple of trees): a
    DTensor's local shard, a plain tensor's shard under its sharding's
    spec (the ``"anycost"`` batch's ``P("pod")``), and 4 for an int leaf
    (the decode cache's ``pos``, the reference's 0-d int32)."""
    if isinstance(tree, (tuple, list)):
        shardings = shardings or (None,) * len(tree)
        return sum(local_bytes(t, s) for t, s in zip(tree, shardings))
    shards = tree_leaves(shardings) if shardings is not None \
        else [None] * len(tree_leaves(tree))
    total = 0
    for t, s in zip(tree_leaves(tree), shards):
        if isinstance(t, int):
            total += 4
        elif shd.is_dtensor(t):
            local = t.to_local()
            total += local.numel() * local.element_size()
        elif isinstance(t, torch.Tensor):
            shape = t.shape if s is None else shd.local_shape(t.shape,
                                                              s.spec)
            total += math.prod(shape) * t.element_size()
    return total


def trace_step(cfg, shape, mesh, *, remat: str = "full",
               causal_skip: bool = False, grad_sync: str = "auto",
               keep_frac: float = 1.0 / 16.0, rules=None) -> dict:
    """Build the step under ``use_sharding(mesh, rules)`` (default
    ``rules_for(shape, grad_sync)``) and trace it once on ``meta``:
    ``{"trace_s", "flops", "collectives" (CollectiveStats), "memory"}``."""
    model = build_model(cfg)
    rules = rules_for(shape, grad_sync) if rules is None else rules
    # repro: ignore[unseeded-randomness] — wall-clock measures the trace
    t0 = time.perf_counter()
    with shd.use_sharding(mesh, rules):
        step, args, in_sh, _ = make_step_and_args(
            model, adamw(3e-4), shape, remat=remat, causal_skip=causal_skip,
            grad_sync=grad_sync, keep_frac=keep_frac, mesh=mesh)
        arg_bytes = local_bytes(args, in_sh)
        out, flops, coll = rl.trace_counts(step, *args)
    # repro: ignore[unseeded-randomness] — wall-clock measures the trace
    trace_s = time.perf_counter() - t0
    memory = dict.fromkeys(MEMORY_FIELDS)
    memory["argument_size_in_bytes"] = arg_bytes
    memory["output_size_in_bytes"] = local_bytes(out)
    return {"trace_s": trace_s, "flops": flops, "collectives": coll,
            "memory": memory}


def run_one(arch: str, shape_name: str, mesh_kind: str, *,
            remat: str = "full", causal_skip: bool = False,
            grad_sync: str = "auto", keep_frac: float = 1.0 / 16.0,
            logits_bf16: bool = False, moe_gather: bool = False,
            expert_zero_decode: bool = False, data_par: int = 16,
            tag: str = "baseline", out_dir: str = OUT_DIR) -> dict:
    entry = plan_entry(arch, shape_name)
    if entry is None:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                "skipped": True,
                "reason": "long_500k unsupported for this family"}
    cfg, shape, note = entry
    if logits_bf16:
        cfg = dataclasses.replace(cfg, logits_bf16=True)
    if moe_gather:
        cfg = dataclasses.replace(cfg, moe_decode="gather")
    fake_group(512 if mesh_kind == "multi" else 256)
    mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"),
                                data_par=data_par, device="cpu")
    rules = dict(rules_for(shape, grad_sync))
    if moe_gather or expert_zero_decode:
        # keep the train-style ZeRO expert sharding at decode
        rules.pop("expert_in", None)
        rules.pop("expert_ff", None)
    tr = trace_step(cfg, shape, mesh, remat=remat, causal_skip=causal_skip,
                    grad_sync=grad_sync, keep_frac=keep_frac, rules=rules)
    sizes = shd.mesh_shape(mesh)
    n_chips = 1
    for v in sizes.values():
        n_chips *= v
    analytic = rl.analytic_cost(
        cfg, shape, remat=remat if shape.kind == "train" else "none",
        causal_skip=causal_skip, n_chips=n_chips,
        data_shards=sizes.get("data", 1) * sizes.get("pod", 1))
    coll = tr["collectives"]
    roof = rl.derive({"flops": tr["flops"]}, coll, n_chips=n_chips,
                     model_flops_total=rl.model_flops(cfg, shape),
                     analytic=analytic)
    return {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind,
        "mesh_desc": describe(mesh), "note": note, "tag": tag,
        "skipped": False,
        "remat": remat, "causal_skip": causal_skip, "grad_sync": grad_sync,
        "logits_bf16": logits_bf16, "keep_frac": keep_frac,
        "lower_s": round(tr["trace_s"], 2), "compile_s": 0.0,
        "memory_analysis": tr["memory"],
        "cost_analysis": {"flops": tr["flops"], "bytes_accessed": None},
        "collectives": coll.to_dict(),
        "roofline": roof.to_dict(),
    }


def save(result: dict, out_dir: str = OUT_DIR):
    os.makedirs(out_dir, exist_ok=True)
    name = (f"{result['arch']}__{result['shape']}__{result['mesh']}"
            f"__{result.get('tag', 'baseline')}.json")
    with open(os.path.join(out_dir, name), "w") as f:
        json.dump(result, f, indent=1)
    return os.path.join(out_dir, name)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--remat", default="full",
                    choices=["full", "dots", "none"])
    ap.add_argument("--causal-skip", action="store_true")
    ap.add_argument("--grad-sync", default="auto",
                    choices=["auto", "anycost"])
    ap.add_argument("--keep-frac", type=float, default=1.0 / 16.0)
    ap.add_argument("--logits-bf16", action="store_true")
    ap.add_argument("--moe-gather", action="store_true")
    ap.add_argument("--expert-zero-decode", action="store_true")
    ap.add_argument("--data-par", type=int, default=16)
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    pairs = []
    if args.all:
        for a in ASSIGNED_ARCHS:
            for s in INPUT_SHAPES:
                pairs.append((a, s))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        pairs.append((args.arch, args.shape))

    failures = 0
    for arch, shape in pairs:
        name = f"{arch}__{shape}__{args.mesh}__{args.tag}.json"
        path = os.path.join(args.out, name)
        if args.skip_existing and os.path.exists(path):
            print(f"[skip-existing] {name}")
            continue
        # repro: ignore[unseeded-randomness] — operator progress timing
        t0 = time.perf_counter()
        try:
            res = run_one(arch, shape, args.mesh, remat=args.remat,
                          causal_skip=args.causal_skip,
                          grad_sync=args.grad_sync,
                          keep_frac=args.keep_frac,
                          logits_bf16=args.logits_bf16,
                          moe_gather=args.moe_gather,
                          expert_zero_decode=args.expert_zero_decode,
                          data_par=args.data_par,
                          tag=args.tag, out_dir=args.out)
            p = save(res, args.out)
            if res.get("skipped"):
                print(f"[SKIP] {arch} x {shape} ({args.mesh}): "
                      f"{res['reason']}")
            else:
                r = res["roofline"]
                print(f"[OK] {arch} x {shape} ({args.mesh}) "
                      # repro: ignore[unseeded-randomness] — progress
                      f"{time.perf_counter() - t0:.0f}s  "
                      f"cmp={r['t_compute']:.3e}s mem={r['t_memory']:.3e}s "
                      f"coll={r['t_collective']:.3e}s -> {r['bottleneck']} "
                      f"({p})", flush=True)
        except Exception as e:
            failures += 1
            print(f"[FAIL] {arch} x {shape} ({args.mesh}): {e}", flush=True)
            traceback.print_exc()
            os.makedirs(args.out, exist_ok=True)
            with open(os.path.join(args.out,
                                   name.replace(".json", ".FAIL.txt")),
                      "w") as f:
                f.write(traceback.format_exc())
    if failures:
        raise SystemExit(f"{failures} dry-run failures")


if __name__ == "__main__":
    main()
