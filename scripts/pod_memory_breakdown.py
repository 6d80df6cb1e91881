"""Where a pod-trainer step's memory goes at an arch's published widths.

  python3 scripts/pod_memory_breakdown.py [--arch phi3-mini-3.8b]
      [--batch 4] [--seq-len 1024] [--remat full]

Builds the arch's published config in bf16 on the card
(``chip_smoke.build_full``), the ``adamw(3e-3, warmup=10)`` state and one
batch of seeded uniform tokens, as ``chip_smoke.py`` phase 12 does; runs
one warm-up step, then one step with the caching allocator's history
recorded.  Replaying the recorded allocations and frees gives the bytes
the step holds above what was live before it, at each moment; at the
moment of the step's peak it prints them grouped by the two innermost
frames of ``repro_torch`` that allocated them (an allocation made by the
autograd engine outside any Python frame of the port counts as
``backward``), the largest first, and the frames of the allocation that
reached the peak.  The first line is the card's name and power limit.
Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import collections
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import chip_smoke  # noqa: E402


def _where(frames: list) -> str:
    """The two innermost ``repro_torch`` frames of an allocation."""
    ours = [f"{os.path.basename(f['filename'])}:{f['line']} {f['name']}"
            for f in frames if "repro_torch" in f["filename"]]
    return " <- ".join(ours[:2]) if ours else "backward"


def replay(trace: list) -> tuple[int, dict, str]:
    """(peak bytes above the start, the live bytes at the peak by
    :func:`_where`, the peak's allocation) from one device's trace."""
    live, total, pre_freed = {}, 0, 0
    peak, at_peak, peak_alloc = 0, {}, ""
    for ev in trace:
        if ev["action"] == "alloc":
            live[ev["addr"]] = (ev["size"], _where(ev.get("frames", [])))
            total += ev["size"]
            if total - pre_freed > peak:
                peak = total - pre_freed
                at_peak = dict(live)
                peak_alloc = live[ev["addr"]][1]
        elif ev["action"] == "free_requested":
            if ev["addr"] in live:
                total -= live.pop(ev["addr"])[0]
            else:       # a block allocated before the recording
                pre_freed += ev["size"]
    groups = collections.Counter()
    for size, where in at_peak.values():
        groups[where] += size
    return peak, groups, peak_alloc


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="phi3-mini-3.8b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=1024)
    ap.add_argument("--remat", default="full")
    ap.add_argument("--top", type=int, default=15)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        chip_smoke.fail("this script needs a CUDA card")
    from repro_torch.device import resolve_device
    from repro_torch.launch.steps import make_train_step
    from repro_torch.train.optimizer import adamw
    print(chip_smoke.card_line(), flush=True)
    resolve_device("cuda")
    model, params = chip_smoke.build_full(args.arch, tag="memory")
    cfg = model.cfg
    opt = adamw(chip_smoke.POD_LR, warmup=chip_smoke.POD_WARMUP)
    state = opt.init(params)
    gen = torch.Generator(device="cuda").manual_seed(12)
    batch = {"tokens": torch.randint(
        0, cfg.vocab_size, (args.batch, args.seq_len), generator=gen,
        device="cuda", dtype=torch.int32)}
    step = make_train_step(model, opt, remat=args.remat)
    params, state, _ = step(params, state, batch)
    torch.cuda.synchronize()
    start = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.memory._record_memory_history(stacks="python",
                                             max_entries=2_000_000)
    params, state, _ = step(params, state, batch)
    torch.cuda.synchronize()
    snap = torch.cuda.memory._snapshot()
    torch.cuda.memory._record_memory_history(enabled=None)
    peak, groups, peak_alloc = replay(snap["device_traces"][0])
    gib = 2**30
    print(f"[memory] {args.arch} B={args.batch}, S={args.seq_len}, remat "
          f"{args.remat}: {start / gib:.3f} GiB live before the step, "
          f"peak {torch.cuda.max_memory_allocated() / gib:.3f} GiB; the "
          f"replay's peak {peak / gib:.3f} GiB above the start, reached "
          f"by an allocation at {peak_alloc}", flush=True)
    for where, size in groups.most_common(args.top):
        print(f"[memory]   {size / gib:8.3f} GiB  {where}", flush=True)
    rest = sum(groups.values()) - sum(
        s for _, s in groups.most_common(args.top))
    print(f"[memory]   {rest / gib:8.3f} GiB  the rest", flush=True)


if __name__ == "__main__":
    main()
