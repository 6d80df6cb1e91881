"""Smoke run of the PyTorch port on one CUDA card.

  python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. Build the port's CUDA kernels from ``src/repro_torch/kernels/csrc``
   (one ``nvcc`` per source, all at once) and print the build seconds
   and the compiler's register report.
2. Hold every kernel function against its plain PyTorch version on the
   card, at the shapes the fmnist-cnn update gives it (N = 1,663,370
   parameters in 8 leaves, K = 622 FGC kernels; 12 devices at the
   server).  Tolerances: level indices, the kept support, the keep mask,
   the threshold step and the streaming absorb/merge exact (the last two
   must also write into the caller's storage, also at N = 1..7 and on a
   plane one element off a 16-byte boundary); norms rtol 1e-5 (the plain
   version sums in another order), per leaf view and as the main path's
   one flat call over the update, which must also give bitwise-equal
   norms on a second call; dequantized values and the batched aggregate
   rtol 1e-6.  The fused step per leaf view and as the main path's one
   launch over the flat update, also on leaves that start off a 16-byte
   boundary, on aligned and misaligned planes.  The threshold step as
   the planner's one launch over the flat update (masked vector and keep
   vector exact) at the fmnist-cnn shapes and on those leaves, aligned
   and misaligned, and per leaf view.  The quantize step over the flat
   masked vector (levels exact, values rtol 1e-6, one launch) at full N,
   at N = 1..7 and on planes one element off a 16-byte boundary.
3. Agreement on small inputs: a 3-device flat run, a 4-device, 2-cell
   hierarchical run and 3-device flat QSGD and UVeQFed runs, each for 2
   rounds on the card and on the CPU (plain versions), same seed, same
   uniforms.  Strategies, cells reporting and
   backhaul bits exact; bits and losses rtol 1e-3 (cuDNN sums in another
   order, which can flip a level index); accuracy within 0.05.  The
   top-k runs record each update's mask on both sides: in round 0 they
   may differ in a few elements at the threshold (``TOPK_FIRST_SWAPS``,
   ``TOPK_FIRST_NEAR``), and from the first round in which they differ
   the loss is held at ``TOPK_LOSS_RTOL`` (a swapped element moves an
   aggregated coordinate by a whole kept value).  Then a 3-device
   fedbuff run (``buffer_size=2``, 30 simulated seconds) on both: the
   event trace, every merge's clients and staleness, the stale drops and
   the peak in-flight count exact; bits, energy and losses rtol 1e-3.
   Then a 4-device flat dynamic run (Markov availability, a battery,
   ``gain`` selection at participation 0.5) and a 4-device, 2-cell
   mobile run (random waypoint, ``nearest`` handover), 2 rounds each,
   on both (:func:`dynamic_pair`): the dispatch log's devices,
   ``n_unavailable``, ``n_aborted``, ``n_handovers``, the cells
   reporting and the trace's event kinds exact; ``t_wall``, bits,
   energy and losses rtol 1e-3; where the gates differ, an availability
   flip must lie between the two runs' round starts.
4. The main paths, each with every launch counter zeroed just before and
   read just after, fmnist-cnn at full width, 12 devices, 3 rounds,
   n_train 1536, the beta planner on, eval every round:
   (a) ``run_fl`` on the flat fleet: kernels #1-#6 must have launched,
       #3/#4 through the planner fit;
   (b) ``run_fl`` on ``TopologyConfig(kind="hier", n_cells=4)``: #7 and
       #8 must have launched and #6 must not; every round reports 4 cells
       and ships 4 f32 partials; #8 launches once per extra reporting
       cell (9).
   In both, #1/#2 launch once per compressed update and planner probe
   (37), #5 once per compressed update (36), and the planner's fit
   launches #3 once per ``rho`` (8) and #4 once per ``(rho, L)`` (80).
   Losses must be finite and the final parameters finite CUDA tensors of
   the model's shapes.
5. Time each kernel's unit of work on the main path (one flat call per
   update for #1/#2 and #5, one per planner ``rho`` for #3, one launch
   for the others), its plain version and, where one PyTorch call computes the
   same function, that call: CUDA events around 20 back-to-back calls,
   so the host's launch cost is in the time, the median of 7 runs;
   beside the least time the card could take (bytes moved over
   3.35 TB/s, or float32 operations over 67 TFLOP/s, whichever is
   larger).  Then each one's device-only time, from replays of a CUDA
   graph of 20 calls (the plain versions take their scalars as 0-d
   tensors on the card, so every one can be captured).  Prints each
   unit's footprint (the bytes of the distinct storages it reads and
   writes) beside the 50 MB L2, and both main-path runs' host wall time.
   Then one ``BetaPlanner.fit`` alone on a probe of the fmnist-cnn
   shapes: its host wall time, the launches of #1-#4 it made, and the
   device-only time of one ``entropy_bits`` call (the 65536-bin
   histogram each of its 80 probes runs), from CUDA-graph replays.
6. The paper's Table I methods and Fig. 5a ablations, each ``run_fl``
   with every launch counter zeroed just before and read just after and
   held to the counts ``expected_launches`` derives from the code paths;
   each prints its host wall time and Table I's columns (best accuracy,
   cumulative energy, latency, FLOPs, MB):
   (a) STC, QSGD, UVeQFed, HeteroFL, FedHQ and FedAvg as phase 4a (no
       planner): #4 once per QSGD and FedHQ update (36), #6 once a round
       (3), no norm, #3 or #5 launch;
   (b) AnycostFL with ``use_ems``, ``use_fgc`` or ``use_aio`` off, the
       planner on: each fits it (8 #3, 80 #4) and compresses every
       update with FGC (``use_fgc=False`` charges the raw update's wire
       size only);
   (c) vgg9-cifar (N = 3,510,858 in 18 leaves): #1/#2, #3, #5 (the flat
       calls), #4 and #6 (12 updates, Theorem-1 weights) against their
       plain versions at its shapes, with phase 2's tolerances, then
       AnycostFL with the planner on, 12
       devices, 3 rounds, on fleet budgets scaled with its work a sample
       (T_max 120 s, E_max in [30, 90] J: on the default ones no device
       finds a feasible strategy);
   (d) #4 on the baselines' operands (a top-k mask at 1/16 and every
       element, L in {2, 16, 65536}): levels exact, values rtol 1e-6;
       UVeQFed's quantizer on the card against the CPU, the same;
   (e) FedHQ on ``TopologyConfig(kind="hier", n_cells=4)``: #7 36, #8 9,
       #4 36, #6 none.
7. The client pool and the asynchronous policies through
   ``run_orchestrated``, fmnist-cnn at full width, 12 devices, n_train
   1536, the planner on, each run with every launch counter zeroed just
   before and read just after and held to the counts
   ``expected_launches`` derives; each prints its host wall time:
   (a) sync with ``use_pool=True`` and ``use_pool=False``, 3 rounds:
       phase 4a's counts in both; round 0, which starts both from one
       model and one channel sort, client by client in job order: the
       same device, its realized bits within ``POOL_BITS_RTOL`` and its
       trained sub-model within ``POOL_LANE_RTOL`` of its update's
       norm; the pooled run's test loss within rtol 1e-3 of the
       sequential run's (batched convolutions sum in another order) in
       every round, from the first round whose EMS channel sort differs
       between the two runs within ``POOL_LOSS_RTOL``;
   (b) semisync, 3 rounds, ``drop`` and ``downweight``, the deadline at
       the median of (a)'s round-0 client durations, so it binds: every
       round accepts and drops exactly the devices (a) trained (the
       numpy stream, hence the fleet's strategies, do not depend on the
       policy); ``drop`` drops at least one update; #6 once per round
       with accepted updates;
   (c) fedbuff, ``buffer_size`` 8, 3 merges, no staleness cap: #5 and #7
       24 launches each, the norm call 25, #3 8, #4 80, #6 and #8 none.
8. Fleet dynamics and mobility through ``run_fl``, the same size and
   planner, each run held to ``expected_launches`` (a churned flight is
   never compressed; at least one round must aggregate); each prints its
   host wall time and per round ``n_clients``, ``n_unavailable``,
   ``n_aborted``, ``n_handovers`` and ``mean_soc``:
   (a) a dynamic flat sync run: Markov availability (seed 0, 30 s on, 15
       s off), ``BatteryConfig(capacity_j=30, recharge_w=0.2)``, ``gain``
       selection at participation 0.5: #6 once per round with accepted
       updates, every dispatch's headroom at least ``min_headroom_j``,
       some device gated out or churned;
   (b) a mobile hierarchy, 4 cells, random waypoint (seed 7, 20-40 m/s),
       ``nearest`` handover with a 25 m margin: #7 once per accepted
       update, #8 once per extra reporting cell, no #6, one HANDOVER
       event per logged handover;
   (c) a replay scenario written to a temporary file
       (:func:`write_scenario`, the 4 sites of ``cell_sites(4, 550)``):
       at least one handover and one CHURN, and cell 3's ships after
       round 0 at its stepped-down 1e7 bit/s;
   (d) a dynamic fedbuff run, buffer 8, 3 merges, (a)'s availability and
       battery and Gauss-Markov motion: RETRY and CHURN events, #5 and
       #7 once per buffered update (24), no #6 or #8.
9. Telemetry on the card (``repro_torch.telemetry``).  First phase 3's
   3-device flat pair with a session on each side and health rules that
   fire every round (:func:`telemetry_card_cpu`): metric names, kinds
   and labels and the alerts exact, ``learning.*`` values within
   :func:`learning_tolerance`.  Then two flat runs under cuDNN's default
   algorithms, whose difference is printed: they need not agree bit for
   bit, so every on/off pair below runs on its deterministic ones.  The
   same size and planner as phase 4, each pair a session (with
   ``HealthEngine(DEFAULT_RULES)``) against none, every ``RoundLog``
   field, the event trace, the dispatch log and the final parameters
   bitwise equal and the launches equal with and without it:
   (a) the flat main path: the launches phase 4a's; the bundle flushed
       and checked (:func:`check_bundle`: the Perfetto JSON declares
       every ``(pid, tid)``, spans have numeric ``ts`` and ``dur`` >= 0,
       the JSONL files parse, alerts carry ``ALERT_KEYS``, the manifest
       validates with ``backend`` ``cuda``, and ``query summary --json``
       is ``History.phase_totals()`` bit for bit); every trained device
       has its five ``learning.*`` gauges a round, the three stage
       energies summing to ``e_total`` within rtol 1e-5;
   (b) the 4-cell hierarchy with the ``int8`` codec and EF: phase 4b's
       launches, ``learning.cell_divergence`` for every reporting cell
       and ``learning.ef_residual_energy`` > 0 from round 1;
   (c) 8d's dynamic fedbuff run: as many CHURN, RETRY and BUFFER_MERGE
       instants as churn and retry events and merges;
   (d) (a) with ``RollupPolicy(device_threshold=8)`` and
       ``trace_sample=0.5``: only hash-sampled device tracks remain;
   (e) one round under ``--torch-profile``'s profiler: its Chrome trace
       names the port's #5 and #6 CUDA kernels.
   (a) and (b) print their 3-round host wall time with telemetry off and
   on (alternating, the median of 3) and the learning recorder's host
   ms a round and its share of the round.

The last lines are the card's name and power limit, one JSON object of
kernels, and the result line.  Without a card, or without the rest of
the repository beside this file, it exits non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import inspect
import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

HBM_BYTES_PER_S = 3.35e12        # H100 SXM
F32_FLOPS = 67e12                # H100 SXM, float32 outside the tensor cores
L2_BYTES = 50e6                  # H100 L2 cache
FMNIST_SHAPES = [(32,), (5, 5, 1, 32), (64,), (5, 5, 32, 64), (512,),
                 (3136, 512), (10,), (512, 10)]
#: leaves that start off a 16-byte boundary (offsets 7 and 21007), N % 4 = 1
MISALIGNED_SHAPES = [(7,), (300, 70), (70,)]
N_DEVICES = 12
N_CELLS = 4
#: phase 3's top-k runs, card against CPU, set from the readings of
#: scripts/topk_card_cpu_agreement.py (QSGD and UVeQFed, 10 seeds, on an
#: H100): in round 0, which starts from the same parameters on both
#: sides, one update's masks may differ in TOPK_FIRST_SWAPS elements at
#: most, each within TOPK_FIRST_NEAR of the CPU's threshold (read: 2
#: elements, 1.0e-3; the updates drifted apart by up to 0.016 of it); the
#: test loss is held at rtol 1e-3 until a round's masks differ and at
#: TOPK_LOSS_RTOL from then on (read: 1.3e-5, and 1.37e-3 once a round's
#: training has started from parameters a swap moved)
TOPK_FIRST_SWAPS = 8
TOPK_FIRST_NEAR = 5e-2
TOPK_LOSS_RTOL = 4e-3
#: phase 7a, the pooled sync run against the sequential one: the test
#: loss is held at rtol 1e-3 while every round's EMS channel sort is the
#: same in both runs, and at POOL_LOSS_RTOL from the first round whose
#: sort differs (a vmapped convolution sums in another order, and the
#: sort can turn that into another sub-model for a device); set from the
#: readings of scripts/pool_sequential_agreement.py (10 seeds).  Round 0
#: starts both runs from one model and one sort, so there each client's
#: trained sub-model is held within POOL_LANE_RTOL of its update's norm
#: (read on the H100: at most 8.5e-4, in one client of a few seeds, most
#: likely a flipped max-pool or ReLU decision, which an elementwise rtol
#: 1e-5 does not cover; a lane left untrained is 1 apart by construction,
#: and another job's result about as far) and its realized bits at
#: POOL_BITS_RTOL (read: up to 7.5e-6; a flipped level index moves the
#: entropy-coded size, a client out of order moves it by far more)
POOL_LOSS_RTOL = 4e-3
POOL_BITS_RTOL = 5e-5
POOL_LANE_RTOL = 1e-2


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, runs: int = 7, warmup: int = 3) -> float:
    """Time of one call of ``fn`` with the host's launch cost in: CUDA
    events around ``iters`` back-to-back calls, the median of ``runs``
    such runs, so that one stall of the shared host does not set it."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return sorted(times)[runs // 2]


def graph_ms(fn, reps: int = 20, replays: int = 10) -> float:
    """Device-only time of one call of ``fn``: ``reps`` calls captured in
    one CUDA graph, its replays timed with CUDA events, so no host work
    sits between the kernels."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):       # warm up off the default stream
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * replays)


def bound_ms(n_bytes: float, n_flops: float) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")



class CpuDrawnUniforms:
    """Uniforms drawn on the CPU and moved to the run's device, so a CPU
    run and a CUDA run get the same numbers."""

    def __init__(self, seed, device):
        import torch
        self.gen = torch.Generator().manual_seed(seed)
        self.device = device

    def _stream(self):
        import torch
        return lambda k: torch.rand(k, generator=self.gen).to(self.device)

    planner_stream = device_stream = _stream


@contextlib.contextmanager
def recording_topk(log: list):
    """Append each top-k update's flat vector and mask (bool), on the
    CPU, and, for QSGD and UVeQFed, its level indices to ``log``, one
    dict an update, in the order the baselines compress them."""
    from repro_torch.train import baselines
    topk, quant, dither = (baselines._topk_mask, baselines._quantize,
                           baselines.dither_quantize)

    def topk_rec(vec, keep_frac):
        mask = topk(vec, keep_frac)
        log.append(dict(mask=mask.bool().cpu(), vec=vec.cpu()))
        return mask

    def quant_rec(vec, mask, n_levels, rand):
        q = quant(vec, mask, n_levels, rand)
        log[-1]["levels"] = q.levels.cpu()
        return q

    def dither_rec(vec, mask, n_levels, rand):
        deq, lvl = dither(vec, mask, n_levels, rand)
        log[-1]["levels"] = lvl.cpu()
        return deq, lvl

    baselines._topk_mask, baselines._quantize, baselines.dither_quantize = \
        topk_rec, quant_rec, dither_rec
    try:
        yield log
    finally:
        baselines._topk_mask, baselines._quantize, \
            baselines.dither_quantize = topk, quant, dither


def small_run_pair(run_cfg, fleet, uniform_seed: int):
    """One synchronous run on the CPU (plain versions) and one on the card,
    same seed, same uniforms.  Returns the two round logs and, per round
    of a top-k method, the most over its updates of: the elements in
    which the card's and the CPU's masks differ (``swaps``), the level
    indices that differ among the elements both keep (``flips``), the
    distance of a swapped element's CPU magnitude from the CPU's
    threshold (``near``) and the largest elementwise difference of the
    two updates (``drift``), both over that threshold (all 0 for a method
    without top-k)."""
    from repro_torch.orchestrator import runner
    from repro_torch.orchestrator.policies import (OrchestratorConfig,
                                                   SyncPolicy)
    logs, recs = {}, {}
    for where in ("cpu", "cuda"):
        sim = runner.Simulation(run_cfg, fleet, device=where,
                                uniforms=CpuDrawnUniforms(uniform_seed,
                                                          where))
        orch = OrchestratorConfig()
        with recording_topk([]) as recs[where]:
            logs[where] = runner._run_round_based(
                sim, SyncPolicy(orch), orch, False).rounds
    n_upd = [r.n_clients + r.n_dropped for r in logs["cpu"]]
    if recs["cpu"] and not len(recs["cpu"]) == len(recs["cuda"]) \
            == sum(n_upd):
        fail(f"{run_cfg.method}: {len(recs['cpu'])} / {len(recs['cuda'])} "
             f"top-k updates recorded, expected {sum(n_upd)}")
    pairs = iter(zip(recs["cpu"], recs["cuda"]))
    diffs = []
    for k in n_upd if recs["cpu"] else [0] * len(n_upd):
        d = dict(swaps=0, flips=0, near=0.0, drift=0.0)
        for c, g in (next(pairs) for _ in range(k)):
            swapped = c["mask"] != g["mask"]
            mag = c["vec"].abs()
            thr = float(mag[c["mask"]].min())
            d["swaps"] = max(d["swaps"], int(swapped.sum()))
            if swapped.any():
                d["near"] = max(d["near"], float(
                    (mag[swapped] - thr).abs().max()) / thr)
            d["drift"] = max(d["drift"], float(
                (g["vec"] - c["vec"]).abs().max()) / thr)
            if "levels" in c:
                both = c["mask"] & g["mask"]
                d["flips"] = max(d["flips"], int(
                    (c["levels"][both] != g["levels"][both]).sum()))
        diffs.append(d)
    return logs, diffs


def theorem1_weights(dev):
    """Theorem-1 weights of the server's ``N_DEVICES`` updates over a
    spread of widths and compression ratios, as #6 takes them."""
    from repro_torch.core.aggregation import optimal_coefficients
    alphas = [(0.25, 0.4, 0.55, 0.7, 0.85, 1.0)[i % 6]
              for i in range(N_DEVICES)]
    betas = [0.002 * (i + 1) for i in range(N_DEVICES)]
    return optimal_coefficients(alphas, betas).to(dev)


def expected_launches(cfg, hist, n_rho: int, n_levels: int,
                      hier: bool, fedbuff: bool = False) -> dict[str, int]:
    """Each kernel's launches in one run, derived from the code paths:
    AnycostFL fits the planner (one norm call, #3 once per rho, #4 once
    per (rho, L)) and compresses every update with FGC (one norm call and
    one #5 each, with ``use_fgc=False`` too, whose wire size alone is the
    raw update's); QSGD and FedHQ quantize each update with one #4; a
    flat round compresses every trained update, accepted or dropped, and
    aggregates with one #6 when it accepted any; a hierarchical one
    absorbs each accepted update (#7) and merges each extra reporting
    cell (#8); a fedbuff merge compresses and absorbs (#7) each buffered
    update and never stacks the buffer (no #6).  A flight that churns
    out of the cell mid-round is prepared but never trained, so it is
    never compressed and counts in none of these; a round that trains
    nobody launches nothing."""
    from repro_torch.kernels import ops
    n_upd = sum(r.n_clients + r.n_dropped for r in hist.rounds)
    anycost = cfg.method == "anycostfl"
    planner = anycost and cfg.use_planner
    want = dict.fromkeys(ops.launch_counts(), 0)
    want["kernel_l2"] = want["kernel_sumsq"] = n_upd * anycost + planner
    want["fused_sparsify_quantize"] = n_upd * anycost
    want["threshold_apply"] = n_rho * planner
    want["prob_quantize"] = n_rho * n_levels * planner \
        + n_upd * (cfg.method in ("qsgd", "fedhq"))
    if hier or fedbuff:
        want["aio_absorb"] = sum(r.n_clients for r in hist.rounds)
        want["aio_merge"] = sum(max(r.n_cells_reporting - 1, 0)
                                for r in hist.rounds)
    else:
        want["aio_aggregate"] = sum(r.n_clients > 0 for r in hist.rounds)
    return want


def drive_run(label: str, run_cfg, fleet, n_rho: int, n_levels: int, *,
              orch=None, hier: bool = False, must: dict = None,
              every_round: bool = True):
    """One ``run_fl`` on the card under ``orch`` (None: sync) with every
    launch counter zeroed just before and read just after.  Every round
    (fedbuff: merge) must aggregate updates, so every kernel of the path
    launches (on a dynamic fleet, ``every_round=False``, at least one
    round must, as a round may find nobody to train); the counts must be
    the ones ``expected_launches`` derives, which must agree with
    ``must``; the losses must be finite and the final parameters finite
    CUDA tensors.  Returns the history, the launches and the host wall
    seconds."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.train.fl_loop import run_fl
    from repro_torch.utils.pytree import tree_leaves
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    hist = run_fl(run_cfg, fleet, orch, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = ops.launch_counts()
    if not (all if every_round else any)(r.n_clients > 0
                                         for r in hist.rounds):
        fail(f"{label}: {'a' if every_round else 'every'} round "
             f"aggregated no update")
    want = expected_launches(run_cfg, hist, n_rho, n_levels, hier,
                             fedbuff=orch is not None
                             and orch.policy == "fedbuff")
    if must and any(want[k] != v for k, v in must.items()):
        fail(f"{label}: expected_launches derived {json.dumps(want)}, "
             f"which disagrees with {json.dumps(must)}")
    if got != want:
        fail(f"{label}: launched {json.dumps(got)}, expected "
             f"{json.dumps(want)}")
    # a round that trained nobody logs no evaluation
    if any(r.test_loss is None and r.n_clients > 0
           or r.test_loss is not None and not math.isfinite(r.test_loss)
           for r in hist.rounds):
        fail(f"{label}: a round's test loss is missing or not finite")
    if not all(bool(torch.isfinite(t).all()) and t.device.type == "cuda"
               for t in tree_leaves(hist.final_params)):
        fail(f"{label}: final parameters are not finite CUDA tensors")
    return hist, got, wall


def table1_phase(card: str, checks_at: dict, n_rho: int,
                 n_levels: int) -> None:
    """Phase 6: the paper's Table I methods, the Fig. 5a ablations,
    vgg9-cifar and a hierarchical FedHQ run through ``run_fl`` on the
    card, each with every launch counter zeroed just before and read
    just after; #4 on the baselines' operands and UVeQFed on the card
    against the CPU."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import compression
    from repro_torch.kernels import quantize, ref, sparsify
    from repro_torch.models.registry import build_model
    from repro_torch.sysmodel.population import VGG9_BUDGETS, FleetConfig
    from repro_torch.topology import TopologyConfig
    from repro_torch.train import baselines
    from repro_torch.train.fl_loop import METHODS, FLRunConfig
    from repro_torch.utils.pytree import tree_leaves

    dev = torch.device("cuda")
    cfg = FLRunConfig(rounds=3, n_train=1536, n_test=384, eval_every=1,
                      seed=0)
    flat = FleetConfig(n_devices=N_DEVICES)

    def masked_range(v, m):
        return tuple(float(x) for x in compression.masked_range(v, m))

    def drive(label, run_cfg, fleet, hier=False, must=None):
        hist, got, wall = drive_run(label, run_cfg, fleet, n_rho, n_levels,
                                    hier=hier, must=must)
        row = hist.to_rows()[-1]
        print(f"[table1] {label}: {wall:.3f} s host wall time; best_acc "
              f"{hist.best_acc:.4f}; cumulative energy "
              f"{row['cum_energy_j']:.4f} J, latency "
              f"{row['cum_latency_s']:.4f} s, FLOPs {row['cum_flops']:.6g}, "
              f"comm {row['cum_comm_bits'] / 8e6:.4f} MB; launches "
              f"{json.dumps({k: v for k, v in got.items() if v})}",
              flush=True)
        return hist

    print(f"[table1] {card}: fmnist-cnn at full width (N = "
          f"{sum(math.prod(s) for s in FMNIST_SHAPES)}), {N_DEVICES} "
          f"devices, {cfg.rounds} rounds, n_train {cfg.n_train}, eval "
          f"every round, flat fleet", flush=True)
    # (a) the Table I matrix: #4 once per QSGD/FedHQ update, #6 once a
    # round, no planner and no FGC kernel
    n_upd = N_DEVICES * cfg.rounds
    for method in METHODS[1:]:
        quantizes = method in ("qsgd", "fedhq")
        drive(method, dataclasses.replace(cfg, method=method), flat,
              must=dict(prob_quantize=n_upd if quantizes else 0,
                        aio_aggregate=cfg.rounds, kernel_l2=0,
                        kernel_sumsq=0, threshold_apply=0,
                        fused_sparsify_quantize=0))
    # (b) the Fig. 5a ablations, planner on: each fits the planner (8 #3,
    # 80 #4) and compresses every feasible device's update with FGC
    for switch in ("use_ems", "use_fgc", "use_aio"):
        drive(f"anycostfl {switch}=False",
              dataclasses.replace(cfg, **{switch: False}), flat,
              must=dict(threshold_apply=n_rho,
                        prob_quantize=n_rho * n_levels))
    # (c) vgg9-cifar: its flat calls against their plain versions at its
    # shapes, then AnycostFL with the planner on
    vcfg = get_config("vgg9-cifar")
    shapes = [tuple(t.shape) for t in tree_leaves(build_model(vcfg).init(
        torch.Generator().manual_seed(0), "cpu"))]
    n = sum(math.prod(s) for s in shapes)
    gen = torch.Generator(device=dev).manual_seed(1)
    vec = torch.randn(n, generator=gen, device=dev) * 1e-2
    rand = torch.rand(n, generator=gen, device=dev)
    for name, kernel, plain in (
            ("kernel_sumsq", sparsify.kernel_sumsq_flat,
             ref.kernel_sumsq_flat_ref),
            ("kernel_l2", sparsify.kernel_l2_flat, ref.kernel_l2_flat_ref)):
        got = kernel(vec, shapes)
        torch.testing.assert_close(got, plain(vec, shapes), rtol=1e-5,
                                   atol=0)
        if not torch.equal(got, kernel(vec, shapes)):
            fail(f"{name} (vgg9-cifar): two flat calls on one input differ")
    norms = sparsify.kernel_l2_flat(vec, shapes)
    thr = float(compression.sparsify_threshold(norms, 0.8))
    keep_mask = compression._element_mask((norms >= thr).float(), shapes)
    u_min, u_max = masked_range(vec, keep_mask)
    checks_at["fused"](vec, rand, shapes, norms, (thr, u_min, u_max, 64.0),
                       "vgg9-cifar")
    checks_at["threshold"](vec, shapes, norms, thr, "vgg9-cifar")
    masked, _ = sparsify.threshold_apply_flat(vec, shapes, norms, thr)
    checks_at["quantize"]((masked, keep_mask, u_min, u_max, 64.0, rand),
                          "vgg9-cifar")
    u = torch.randn(N_DEVICES, n, generator=gen, device=dev) * 1e-2
    m = (torch.rand(N_DEVICES, n, generator=gen, device=dev) > 0.4).float()
    checks_at["aggregate"](u, m, theorem1_weights(dev), "vgg9-cifar")
    del u, m
    print(f"[table1] vgg9-cifar flat calls over {len(shapes)} leaves, N = "
          f"{n}: norms rtol 1e-5 and bitwise stable, fused levels and "
          f"support exact, threshold exact, quantize levels exact, values "
          f"rtol 1e-6; aio_aggregate over {N_DEVICES} updates, one launch, "
          f"rtol 1e-6", flush=True)
    vhist = drive("vgg9-cifar anycostfl",
                  dataclasses.replace(cfg, arch="vgg9-cifar"),
                  FleetConfig(n_devices=N_DEVICES, **VGG9_BUDGETS))
    if [tuple(t.shape) for t in tree_leaves(vhist.final_params)] != shapes:
        fail("vgg9-cifar: final parameter shapes differ from the model's")
    # (d) #4 on the baselines' operands: a top-k mask at 1/16 (QSGD) and
    # every element (FedHQ), L up to 65536; UVeQFed on the card vs the CPU
    fvec = vec[:sum(math.prod(s) for s in FMNIST_SHAPES)]
    frand = rand[:fvec.numel()]
    for label, mask in (("top-k 1/16", baselines._topk_mask(fvec, 1 / 16)),
                        ("every element", torch.ones_like(fvec))):
        lo, hi = masked_range(fvec, mask)
        for L in (2.0, 16.0, 65536.0):
            args = (fvec, mask, lo, hi, L, frand)
            before = quantize.launches["prob_quantize"]
            q, lvl = quantize.prob_quantize(*args)
            qr, lr = ref.quantize_ref(*args)
            if quantize.launches["prob_quantize"] != before + 1 \
                    or not torch.equal(lvl, lr) or int(lvl.max()) > L:
                fail(f"prob_quantize ({label}, L = {L:g}): level indices "
                     f"differ from the plain version's")
            torch.testing.assert_close(q, qr, rtol=1e-6, atol=0)
    uv = []
    for where in (dev, torch.device("cpu")):
        v, r = fvec.to(where), frand.to(where)
        uv.append(baselines.dither_quantize(
            v, baselines._topk_mask(v, 1 / 16), 16, r))
    if not torch.equal(uv[0][1].cpu(), uv[1][1]):
        fail("uveqfed: level indices on the card differ from the CPU's")
    torch.testing.assert_close(uv[0][0].cpu(), uv[1][0], rtol=1e-6, atol=0)
    print("[table1] prob_quantize on a top-k 1/16 mask and on every "
          "element, L in {2, 16, 65536}: levels exact, values rtol 1e-6; "
          "uveqfed card vs CPU: levels exact, values rtol 1e-6", flush=True)
    # (e) hierarchical FedHQ: #7 per accepted update, #8 per extra cell,
    # #4 per update, no #6
    drive("fedhq hier", dataclasses.replace(cfg, method="fedhq"),
          FleetConfig(n_devices=N_DEVICES, topology=TopologyConfig(
              kind="hier", n_cells=N_CELLS)), hier=True,
          must=dict(aio_absorb=n_upd, aio_merge=(N_CELLS - 1) * cfg.rounds,
                    prob_quantize=n_upd, aio_aggregate=0))


@contextlib.contextmanager
def recording_rounds(rounds: list, clients: list):
    """Append each round's start parameters (with the run's shrink spec)
    to ``rounds``, and each materialized client's ``(client_id, bits,
    T_cmp + T_com, trained sub-model, the sub-model it trained from or
    None)`` to ``clients`` (the start is the client pool's; one client
    at a time, it is shrunk in the decode), in the order the runner
    takes them.  Only references are kept, so the recorded run
    does no extra work; :func:`sort_perms` reads the channel sorts after
    it."""
    from repro_torch.orchestrator import runner
    sort, mat = runner.Simulation.sort_params, runner.Simulation.materialize

    def sort_params(self, params):
        rounds.append((self.spec, params))
        return sort(self, params)

    def materialize(self, p, trained, *a, **k):
        p = mat(self, p, trained, *a, **k)
        clients.append((p.client_id, p.update.bits, p.duration, trained,
                        k.get("sub")))
        return p

    runner.Simulation.sort_params = sort_params
    runner.Simulation.materialize = materialize
    try:
        yield
    finally:
        runner.Simulation.sort_params = sort
        runner.Simulation.materialize = mat


def sort_perms(rounds: list) -> list:
    """Each recorded round's EMS channel-sort permutations, as lists."""
    from repro_torch.core import shrinking
    return [[p.tolist() for p in shrinking.sort_channels(
        params, spec, return_perms=True)[1]] for spec, params in rounds]


def lane_drift(got, want, start) -> float:
    """How far two trainings of one job from ``start`` land apart, as a
    share of the update one of them made: ``|got - want|`` over
    ``|start - want|``, Euclidean norms over every leaf."""
    from repro_torch.utils.pytree import tree_leaves

    def dist(a, b):
        return math.sqrt(sum(float(((x - y) ** 2).sum())
                             for x, y in zip(tree_leaves(a), tree_leaves(b))))
    return dist(got, want) / dist(start, want)


def async_phase(n_rho: int, n_levels: int) -> dict:
    """Phase 7: the client pool, semisync and fedbuff through ``run_fl``
    (``run_orchestrated``) on the card, each run held by
    :func:`drive_run`.  Returns each run's launches."""
    import statistics

    from repro_torch.orchestrator.policies import OrchestratorConfig
    from repro_torch.sysmodel.population import FleetConfig
    from repro_torch.train.fl_loop import FLRunConfig
    from repro_torch.utils.pytree import tree_leaves

    cfg = FLRunConfig(rounds=3, n_train=1536, n_test=384, eval_every=1,
                      seed=0, use_planner=True)
    fleet = FleetConfig(n_devices=N_DEVICES)
    launched = {}

    def drive(label, orch, must=None):
        hist, got, wall = drive_run(label, cfg, fleet, n_rho, n_levels,
                                    orch=orch, must=must)
        launched[label] = got
        if [tuple(t.shape) for t in tree_leaves(hist.final_params)] \
                != FMNIST_SHAPES:
            fail(f"{label}: final parameter shapes differ from the model's")
        print(f"[async] {label}: {wall:.3f} s host wall time; rounds "
              f"(n_clients, n_dropped, mean_staleness, latency_s, "
              f"test_loss) "
              f"{[(r.n_clients, r.n_dropped, r.mean_staleness, round(r.latency_s, 4), r.test_loss) for r in hist.rounds]}; "
              f"launches {json.dumps({k: v for k, v in got.items() if v})}",
              flush=True)
        return hist, wall

    print(f"[async] fmnist-cnn at full width, {N_DEVICES} devices, "
          f"n_train {cfg.n_train}, planner on, flat fleet", flush=True)
    # (a) sync, pooled and sequential: round 0 (one start, one sort)
    # client by client, then the loss at rtol 1e-3 until a round's
    # channel sort differs between them
    seq_rounds, seq_clients, pool_rounds, pool_clients = [], [], [], []
    with recording_rounds(seq_rounds, seq_clients):
        seq, seq_wall = drive("sync sequential",
                              OrchestratorConfig(use_pool=False))
    with recording_rounds(pool_rounds, pool_clients):
        pooled, pool_wall = drive("sync pooled",
                                  OrchestratorConfig(use_pool=True))
    if [r.n_clients for r in seq.rounds] != \
            [r.n_clients for r in pooled.rounds]:
        fail("sync pooled: the rounds trained other devices than the "
             "sequential run's")
    live = [r.n_clients + r.n_dropped for r in seq.rounds]
    bits_rel = drift = 0.0
    for (ci, bi, _, ti, _), (cj, bj, _, tj, start) in zip(
            seq_clients[:live[0]], pool_clients[:live[0]]):
        bits_rel = max(bits_rel, abs(bj - bi) / bi)
        drift = max(drift, lane_drift(tj, ti, start))
        if ci != cj or not abs(bj - bi) <= POOL_BITS_RTOL * bi \
                or not drift <= POOL_LANE_RTOL:
            fail(f"sync pooled: round 0's client {cj} (sequential: {ci}) "
                 f"realized {bj} bits against {bi} (rtol {POOL_BITS_RTOL}"
                 f"); trained parameters {drift:.3e} of the update's norm "
                 f"apart (limit {POOL_LANE_RTOL})")
    print(f"[async] sync round 0, client by client in job order, pooled "
          f"vs sequential: bits within {bits_rel:.3e} relative, trained "
          f"parameters within {drift:.3e} of the update's norm",
          flush=True)
    perms, pool_perms = sort_perms(seq_rounds), sort_perms(pool_rounds)
    swapped = False
    for t, (c, g) in enumerate(zip(seq.rounds, pooled.rounds)):
        swapped = swapped or perms[t] != pool_perms[t]
        rtol = POOL_LOSS_RTOL if swapped else 1e-3
        if not abs(c.test_loss - g.test_loss) <= rtol * abs(c.test_loss):
            fail(f"sync pooled: round {t}'s test loss {g.test_loss} vs the "
                 f"sequential run's {c.test_loss} (rtol {rtol})")
    first = next((t for t, (a, b) in enumerate(zip(perms, pool_perms))
                  if a != b), None)
    print(f"[async] sync, 3 rounds: pooled {pool_wall:.3f} s, sequential "
          f"{seq_wall:.3f} s of host wall time; test loss "
          f"{[r.test_loss for r in pooled.rounds]} vs "
          f"{[r.test_loss for r in seq.rounds]}; channel sorts "
          f"{'the same in every round' if first is None else f'differ from round {first}'}",
          flush=True)
    # (b) semisync at a binding deadline
    deadline = statistics.median(c[2] for c in seq_clients[:live[0]])
    for mode in ("drop", "downweight"):
        hist, _ = drive(f"semisync {mode}", OrchestratorConfig(
            policy="semisync", deadline_s=deadline, straggler_mode=mode))
        for r, n in zip(hist.rounds, live):
            if r.n_clients + r.n_dropped != n:
                fail(f"semisync {mode} round {r.round}: {r.n_clients} "
                     f"accepted + {r.n_dropped} dropped, {n} trained")
        dropped = sum(r.n_dropped for r in hist.rounds)
        if (mode == "drop") != (dropped > 0):
            fail(f"semisync {mode}: {dropped} updates dropped at the "
                 f"{deadline:.4f} s deadline")
    print(f"[async] semisync deadline {deadline:.6f} s (median of round "
          f"0's {live[0]} client durations)", flush=True)
    # (c) fedbuff: 3 merges of 8 buffered updates
    k, merges = 8, cfg.rounds
    hist, _ = drive("fedbuff", OrchestratorConfig(policy="fedbuff",
                                                  buffer_size=k),
                    must=dict(fused_sparsify_quantize=merges * k,
                              aio_absorb=merges * k,
                              kernel_l2=merges * k + 1,
                              threshold_apply=n_rho,
                              prob_quantize=n_rho * n_levels,
                              aio_aggregate=0, aio_merge=0))
    if [r.n_clients for r in hist.rounds] != [k] * merges:
        fail(f"fedbuff: merges of {[r.n_clients for r in hist.rounds]} "
             f"updates, expected {merges} of {k}")
    print(f"[async] fedbuff: {merges} merges of {k}, peak in flight "
          f"{hist.peak_inflight}, staleness per merge "
          f"{[r.mean_staleness for r in hist.rounds]}", flush=True)
    return launched


def dynamic_pair(label: str, run_cfg, fleet) -> None:
    """Phase 3's dynamic and mobile runs: one ``run_orchestrated`` on the
    CPU and one on the card, same seed, same uniforms.  Exact: the
    dispatch log's devices, each round's ``n_unavailable``,
    ``n_aborted``, ``n_handovers`` and cells reporting, and the trace's
    event kinds; rtol 1e-3: ``t_wall``, bits, energy and losses.  A round
    starts at the previous one's ``t_wall``, which holds the realized
    uplink time, so the two runs start a round a last-bit apart; where an
    availability flip lies between the two starts, the gates may differ
    from that round on, which is shown (the flip and the gap) and ends
    the comparison; any other difference fails."""
    from repro_torch.fleet import make_trace
    from repro_torch.orchestrator.runner import run_orchestrated
    hists = {where: run_orchestrated(run_cfg, fleet, None, device=where,
                                     uniforms=CpuDrawnUniforms(7, where))
             for where in ("cpu", "cuda")}
    c_h, g_h = hists["cpu"], hists["cuda"]
    trace = make_trace(fleet.dynamics.availability, fleet.n_devices) \
        if fleet.dynamics is not None else None
    # a round that trained nobody logs its start, and the idle server
    # then moves the clock a deadline on
    starts = {w: [0.0] + [r.t_wall + (fleet.T_max if r.flops == 0 else 0.0)
                          for r in h.rounds[:-1]]
              for w, h in hists.items()}
    dlog = {w: {} for w in hists}
    for w, h in hists.items():
        for t, i, _ in h.dispatch_log:
            dlog[w].setdefault(t, []).append(i)
    if len(c_h.rounds) != len(g_h.rounds):
        fail(f"{label}: {len(g_h.rounds)} rounds on the card, "
             f"{len(c_h.rounds)} on the CPU")
    explained = None
    for k, (c, g) in enumerate(zip(c_h.rounds, g_h.rounds)):
        t_c, t_g = starts["cpu"][k], starts["cuda"][k]
        same = (c.n_unavailable, c.n_aborted, c.n_handovers,
                c.n_cells_reporting, c.n_clients) == \
            (g.n_unavailable, g.n_aborted, g.n_handovers,
             g.n_cells_reporting, g.n_clients) \
            and dlog["cpu"].get(t_c) == dlog["cuda"].get(t_g)
        if not same:
            lo, hi = min(t_c, t_g), max(t_c, t_g)
            flips = [(i, trace.next_change(i, lo))
                     for i in range(fleet.n_devices)] if trace else []
            flips = [(i, f) for i, f in flips if f <= hi]
            if not flips:
                fail(f"{label}: round {k}'s gates, cohort or cells differ "
                     f"between the card and the CPU with no availability "
                     f"flip between their starts {t_g!r} and {t_c!r}")
            explained = (k, lo, hi, flips)
            break
        for f in ("t_wall", "comm_bits", "energy_j", "test_loss"):
            a, b = getattr(c, f), getattr(g, f)
            if (a is None) != (b is None) or a is not None \
                    and not abs(a - b) <= 1e-3 * abs(a):
                fail(f"{label}: {f} {b} on the card vs {a} on the CPU in "
                     f"round {k} (rtol 1e-3)")
    if explained is None:
        if [e[2] for e in c_h.trace] != [e[2] for e in g_h.trace] \
                or [d[1] for d in c_h.dispatch_log] != \
                [d[1] for d in g_h.dispatch_log]:
            fail(f"{label}: the trace's event kinds or the dispatch log's "
                 f"devices differ between the card and the CPU")
        note = "every round agrees"
    else:
        k, lo, hi, flips = explained
        note = (f"from round {k} the gates differ: availability flips "
                f"{flips} lie between the two starts {lo!r} and {hi!r}")
    per_round = [(r.n_clients, r.n_unavailable, r.n_aborted, r.n_handovers,
                  r.n_cells_reporting) for r in g_h.rounds]
    print(f"[agree] {label}, card vs CPU: rounds (n_clients, "
          f"n_unavailable, n_aborted, n_handovers, n_cells_reporting) "
          f"{per_round}; events {[e[2] for e in g_h.trace]}; t_wall "
          f"{[r.t_wall for r in g_h.rounds]} vs "
          f"{[r.t_wall for r in c_h.rounds]}; test_loss "
          f"{[r.test_loss for r in g_h.rounds]} vs "
          f"{[r.test_loss for r in c_h.rounds]}; {note}", flush=True)


def write_scenario(path: str) -> dict:
    """Phase 8c's world: 12 devices over the 4 ring sites of
    ``cell_sites(4, 550)``, written to ``path``.  Devices 0 and 1 cross
    from one site's area to the next's within 20 s; device 2 leaves the
    cell at t = 1 s, inside round 0 (every planned round of this fleet
    lasts several seconds); the rest stand near a site, and cell 3 keeps
    three of them, always on, so it reports every round; cell 3's
    backhaul steps from 1e9 to 1e7 bit/s at t = 1 s, after round 0's
    ship (at its start, t = 0)."""
    from repro_torch.mobility import ScenarioTrace
    from repro_torch.topology import cell_sites
    sites = cell_sites(N_CELLS, 550.0)

    def near(k, dx, dy):
        return [[0.0, float(sites[k][0] + dx), float(sites[k][1] + dy)]]

    devices = [
        {"waypoints": [[0.0, 260.0, 10.0], [20.0, 10.0, 260.0]]},
        {"waypoints": [[0.0, -260.0, -10.0], [20.0, -10.0, -260.0]]},
        {"waypoints": near(0, -25.0, -30.0), "on": [[0.0, 1.0]]},
        {"waypoints": near(0, -40.0, 20.0)},
        {"waypoints": near(0, 15.0, 45.0)},
        {"waypoints": near(1, 30.0, -20.0)},
        {"waypoints": near(1, -35.0, -10.0)},
        {"waypoints": near(2, 20.0, 30.0)},
        {"waypoints": near(2, 10.0, -40.0)},
        {"waypoints": near(3, -30.0, 15.0)},
        {"waypoints": near(3, 25.0, 20.0)},
        {"waypoints": near(3, 5.0, -35.0)},
    ]
    cells = [{"site": [float(x), float(y)]} for x, y in sites]
    cells[3]["backhaul_bps"] = [[0.0, 1e9], [1.0, 1e7]]
    ScenarioTrace(devices=devices, cells=cells).save(path)
    return dict(churner=2, low_rate_cell=3, low_rate=1e7)


@contextlib.contextmanager
def timing_control_plane(acc: dict):
    """Add the host seconds spent in the round-based control plane to
    ``acc``: the gates and selection (``Simulation.gate_round``), the
    handover decision (``HandoverEngine.reassign``) and the motion
    models' positions (``Fleet.positions``, ``Fleet.device_env``)."""
    from repro_torch.mobility.handover import HandoverEngine
    from repro_torch.orchestrator.runner import Simulation
    from repro_torch.sysmodel.population import Fleet
    patched = [(Simulation, "gate_round", "gate"),
               (HandoverEngine, "reassign", "handover"),
               (Fleet, "positions", "positions"),
               (Fleet, "device_env", "device_env")]
    originals = [getattr(cls, name) for cls, name, _ in patched]

    def timed(fn, key):
        def wrapper(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                acc[key] = acc.get(key, 0.0) + time.perf_counter() - t0
        return wrapper

    for (cls, name, key), fn in zip(patched, originals):
        setattr(cls, name, timed(fn, key))
    try:
        yield acc
    finally:
        for (cls, name, _), fn in zip(patched, originals):
            setattr(cls, name, fn)


def fleet_phase(n_rho: int, n_levels: int) -> dict:
    """Phase 8: fleet dynamics and mobility through ``run_fl`` on the
    card, each run held by :func:`drive_run` (at least one round must
    aggregate).  Returns each run's launches."""
    import tempfile

    from repro_torch.fleet import (AvailabilityConfig, BatteryConfig,
                                   FleetDynamicsConfig)
    from repro_torch.mobility import HandoverConfig, MobilityConfig
    from repro_torch.orchestrator.policies import OrchestratorConfig
    from repro_torch.sysmodel.population import FleetConfig
    from repro_torch.topology import TopologyConfig, payload_bits
    from repro_torch.train.fl_loop import FLRunConfig

    cfg = FLRunConfig(rounds=3, n_train=1536, n_test=384, eval_every=1,
                      seed=0, use_planner=True)
    battery = BatteryConfig(capacity_j=30.0, recharge_w=0.2, seed=0)
    dyn = FleetDynamicsConfig(
        availability=AvailabilityConfig(kind="markov", seed=0,
                                        mean_on_s=30.0, mean_off_s=15.0),
        battery=battery, selection="gain", participation=0.5)
    launched = {}

    def kinds(hist):
        out = {}
        for e in hist.trace:
            out[e[2]] = out.get(e[2], 0) + 1
        return out

    def drive(label, fleet, orch=None, hier=False, must=None):
        with timing_control_plane({}) as plane:
            hist, got, wall = drive_run(label, cfg, fleet, n_rho, n_levels,
                                        orch=orch, hier=hier, must=must,
                                        every_round=False)
        launched[label] = got
        per_round = [(r.n_clients, r.n_unavailable, r.n_aborted,
                      r.n_handovers, r.mean_soc) for r in hist.rounds]
        print(f"[fleet] {label}: {wall:.3f} s host wall time; rounds "
              f"(n_clients, n_unavailable, n_aborted, n_handovers, "
              f"mean_soc) {per_round}; events {json.dumps(kinds(hist))}; "
              f"control-plane host ms "
              f"{json.dumps({k: v * 1e3 for k, v in plane.items()})}; "
              f"launches {json.dumps({k: v for k, v in got.items() if v})}",
              flush=True)
        return hist

    print(f"[fleet] fmnist-cnn at full width, {N_DEVICES} devices, "
          f"n_train {cfg.n_train}, {cfg.rounds} rounds, planner on",
          flush=True)
    # (a) dynamic flat sync: #6 once per round that accepted an update
    hist = drive("8a dynamic flat", FleetConfig(n_devices=N_DEVICES,
                                                dynamics=dyn),
                 must=dict(aio_absorb=0, aio_merge=0))
    low = [h for _, _, h in hist.dispatch_log
           if h < battery.min_headroom_j]
    if low:
        fail(f"8a dynamic flat: dispatched with headroom {low} J, below "
             f"{battery.min_headroom_j} J")
    if sum(r.n_unavailable + r.n_aborted for r in hist.rounds) == 0:
        fail("8a dynamic flat: no device was gated out or churned")
    # (b) mobile hierarchical sync: #7 per accepted update, #8 per extra
    # reporting cell, #6 never; one HANDOVER event a move
    mob_hier = FleetConfig(
        n_devices=N_DEVICES, topology=TopologyConfig(
            kind="hier", n_cells=N_CELLS,
            handover=HandoverConfig("nearest", margin_m=25.0)),
        mobility=MobilityConfig(kind="random_waypoint", seed=7,
                                speed_range=(20.0, 40.0)))
    hist = drive("8b mobile hier", mob_hier, hier=True,
                 must=dict(aio_aggregate=0))
    if kinds(hist).get("handover", 0) != hist.total_handovers():
        fail(f"8b mobile hier: {kinds(hist).get('handover', 0)} HANDOVER "
             f"events, {hist.total_handovers()} handovers logged")
    # (c) a replay scenario written here: crossings, a mid-round exit and
    # a backhaul that steps down after round 0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "scenario.json")
        world = write_scenario(path)
        fleet = FleetConfig(
            n_devices=N_DEVICES, topology=TopologyConfig(
                kind="hier", n_cells=N_CELLS,
                handover=HandoverConfig("nearest", margin_m=25.0)),
            mobility=MobilityConfig(kind="replay", scenario_file=path),
            dynamics=FleetDynamicsConfig(availability=AvailabilityConfig(
                kind="replay", trace_file=path)))
        hist = drive("8c replay scenario", fleet, hier=True,
                     must=dict(aio_aggregate=0))
    ship = payload_bits(sum(math.prod(s) for s in FMNIST_SHAPES),
                        len(FMNIST_SHAPES), "f32")
    slow = fleet.topology.backhaul.latency_s + ship / world["low_rate"]
    churned = [e[3] for e in hist.trace if e[2] == "churn"]
    if hist.total_handovers() == 0 or world["churner"] not in churned:
        fail(f"8c replay scenario: {hist.total_handovers()} handovers, "
             f"devices {churned} churned; expected a handover and device "
             f"{world['churner']}'s exit")
    # every round after round 0 starts past the step, and the slowed cell
    # (always reporting) ships longest, so it sets the backhaul latency
    later = [r.latency_backhaul_s for r in hist.rounds[1:]]
    if hist.rounds[0].latency_backhaul_s >= slow \
            or not all(abs(x - slow) <= 1e-9 * slow for x in later):
        fail(f"8c replay scenario: backhaul latencies "
             f"{[r.latency_backhaul_s for r in hist.rounds]} s, expected "
             f"{slow} s (cell {world['low_rate_cell']} at "
             f"{world['low_rate']:g} bit/s) after round 0")
    print(f"[fleet] 8c: cell {world['low_rate_cell']}'s ships after round "
          f"0 take {slow:.6f} s at {world['low_rate']:g} bit/s; backhaul "
          f"latency per round "
          f"{[r.latency_backhaul_s for r in hist.rounds]}", flush=True)
    # (d) dynamic fedbuff with motion: #5 and #7 per buffered update, no
    # #6 or #8; gated devices RETRY, flights CHURN
    k, merges = 8, cfg.rounds
    hist = drive("8d dynamic fedbuff", FleetConfig(
        n_devices=N_DEVICES, dynamics=dataclasses.replace(
            dyn, selection="uniform", participation=1.0),
        mobility=MobilityConfig(kind="gauss_markov", seed=0)),
        orch=OrchestratorConfig(policy="fedbuff", buffer_size=k),
        must=dict(fused_sparsify_quantize=merges * k,
                  aio_absorb=merges * k, aio_aggregate=0, aio_merge=0))
    ev = kinds(hist)
    if ev.get("retry", 0) == 0 or ev.get("churn", 0) == 0:
        fail(f"8d dynamic fedbuff: events {ev}, expected RETRY and CHURN")
    if [r.n_clients for r in hist.rounds] != [k] * merges:
        fail(f"8d dynamic fedbuff: merges of "
             f"{[r.n_clients for r in hist.rounds]}, expected {merges} of "
             f"{k}")
    return launched


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN's deterministic algorithms for the enclosed runs.  Two runs
    of the same configuration in one process differ on the card under
    the default algorithms (phase 9 prints by how much), so a bitwise
    comparison of telemetry on against off needs them."""
    import torch
    saved = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        yield
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = saved


@contextlib.contextmanager
def timing_recorder(acc: list):
    """Append the host seconds of every ``LearningRecorder`` call to
    ``acc`` (the calls read their statistics off the card, so each one's
    device work is inside its time)."""
    from repro_torch.telemetry.learning import LearningRecorder
    names = ("device_stats", "record_device", "record_alignment",
             "record_cell", "record_ef_residual", "note_contribution",
             "record_round")
    originals = [getattr(LearningRecorder, n) for n in names]

    def timed(fn):
        def wrapper(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                acc.append(time.perf_counter() - t0)
        return wrapper

    for n, fn in zip(names, originals):
        setattr(LearningRecorder, n, timed(fn))
    try:
        yield acc
    finally:
        for n, fn in zip(names, originals):
            setattr(LearningRecorder, n, fn)


def same_run(label: str, on, off) -> None:
    """Every ``RoundLog`` field, the event trace, the dispatch log and
    the final parameters bitwise equal."""
    import torch
    from repro_torch.utils.pytree import tree_leaves
    if [dataclasses.asdict(r) for r in on.rounds] != \
            [dataclasses.asdict(r) for r in off.rounds]:
        fail(f"{label}: a RoundLog field differs with telemetry on")
    if on.trace != off.trace or on.dispatch_log != off.dispatch_log:
        fail(f"{label}: the event trace or the dispatch log differs with "
             f"telemetry on")
    if not all(torch.equal(a, b) for a, b in zip(
            tree_leaves(on.final_params), tree_leaves(off.final_params))):
        fail(f"{label}: the final parameters differ with telemetry on")


def check_bundle(label: str, tel, hist, run_cfg, fleet) -> dict:
    """Flush ``tel`` with its manifest to a temporary directory and check
    every file of the bundle; ``query summary --json`` must give
    ``History.phase_totals()`` back bit for bit.  Returns the file
    sizes."""
    import io
    import tempfile

    from repro_torch.telemetry import (ALERT_KEYS, build_manifest, query,
                                       validate_manifest)
    with tempfile.TemporaryDirectory() as tmp:
        paths = tel.flush(manifest=build_manifest(
            run_cfg, fleet, trace_signature=hist.trace, device="cuda"),
            out_dir=tmp)
        if set(paths) != {"perfetto", "trace_jsonl", "metrics_jsonl",
                          "alerts_jsonl", "manifest"}:
            fail(f"{label}: the bundle holds {sorted(paths)}")
        with open(paths["perfetto"]) as f:
            doc = json.load(f)
        declared = {(e["pid"], e["tid"]) for e in doc["traceEvents"]
                    if e["ph"] == "M" and e["name"] == "thread_name"}
        for e in doc["traceEvents"]:
            if e["ph"] == "M":
                continue
            if (e["pid"], e["tid"]) not in declared:
                fail(f"{label}: perfetto event {e['name']} on an "
                     f"undeclared (pid, tid) {(e['pid'], e['tid'])}")
            if e["ph"] == "X" and not (
                    isinstance(e["ts"], (int, float))
                    and isinstance(e["dur"], (int, float))
                    and e["dur"] >= 0):
                fail(f"{label}: span {e['name']} has ts {e['ts']!r}, dur "
                     f"{e['dur']!r}")
        lines = {}
        for kind in ("trace_jsonl", "metrics_jsonl", "alerts_jsonl"):
            with open(paths[kind]) as f:
                lines[kind] = [json.loads(x) for x in f if x.strip()]
        bad = [a for a in lines["alerts_jsonl"]
               if tuple(sorted(a)) != tuple(sorted(ALERT_KEYS))]
        if bad:
            fail(f"{label}: alert records with keys {sorted(bad[0])}")
        if len(lines["alerts_jsonl"]) != len(tel.health.alerts()):
            fail(f"{label}: alerts.jsonl holds {len(lines['alerts_jsonl'])} "
                 f"lines, the engine raised {len(tel.health.alerts())}")
        with open(paths["manifest"]) as f:
            man = json.load(f)
        if validate_manifest(man) or man["backend"] != "cuda":
            fail(f"{label}: manifest missing {validate_manifest(man)}, "
                 f"backend {man.get('backend')!r}")
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            query.main(["summary", "--telemetry-dir", tmp, "--json"])
        if json.loads(out.getvalue()) != hist.phase_totals():
            fail(f"{label}: query summary --json is not "
                 f"History.phase_totals() bit for bit")
        return {k: len(v) for k, v in lines.items()}


def learning_tolerance(rec: dict, reg) -> tuple[float, float]:
    """(rtol, atol) of one ``learning.*`` value, card against CPU: rtol
    1e-3 (phase 3's bound for bits and losses); the cosines also atol
    1e-3, and from round 1 on the stage energies 2e-3 of the device's
    update energy (a kernel at the sparsification threshold or a level
    index that flips moves a whole kernel's quantization error), as
    ``tests/test_torch_learning.py`` holds the port to the reference."""
    name, lab = rec["name"], rec["labels"]
    if name in ("learning.cosine_alignment", "learning.cell_divergence"):
        return 1e-3, 1e-3
    if name in ("learning.error_energy", "learning.error_total") \
            and lab["round"] > 0:
        return 1e-3, 2e-3 * reg.value("learning.update_norm",
                                      device=lab["device"],
                                      round=lab["round"]) ** 2
    return 1e-3, 0.0


def telemetry_card_cpu(run_cfg, fleet) -> None:
    """Phase 9's card-against-CPU pair: phase 3's 3-device flat run with
    a session on each side, and health rules that fire in every round.
    Exact: the metric names, kinds and label sets and the alerts' rule,
    round, kind, severity and signal; ``learning.*`` values within
    :func:`learning_tolerance`.  The card's session is flushed through
    :func:`check_bundle`, so its ``alerts.jsonl`` holds those alerts."""
    from repro_torch import telemetry as tm
    from repro_torch.orchestrator import runner
    from repro_torch.orchestrator.policies import (OrchestratorConfig,
                                                   SyncPolicy)
    rules = tm.DEFAULT_RULES + (
        tm.HealthRule("silent", "silent_devices",
                      params=dict(threshold=-1.0, min_round=0)),
        tm.HealthRule("backhaul", "backhaul_saturation",
                      params=dict(threshold=-1.0)))
    tels, hists = {}, {}
    for where in ("cpu", "cuda"):
        tels[where] = tm.Telemetry()
        tels[where].health = tm.HealthEngine(rules)
        sim = runner.Simulation(run_cfg, fleet, device=where,
                                uniforms=CpuDrawnUniforms(7, where),
                                telemetry=tels[where])
        orch = OrchestratorConfig()
        hists[where] = runner._run_round_based(sim, SyncPolicy(orch), orch,
                                               False)
    recs = {w: list(t.registry.records()) for w, t in tels.items()}

    def key(r):
        return r["name"], r["kind"], sorted(r["labels"].items())

    if [key(r) for r in recs["cuda"]] != [key(r) for r in recs["cpu"]]:
        fail("telemetry card vs CPU: metric names, kinds or labels differ")
    worst = 0.0
    for g, c in zip(recs["cuda"], recs["cpu"]):
        if not g["name"].startswith("learning."):
            continue
        rtol, atol = learning_tolerance(c, tels["cpu"].registry)
        if not abs(g["value"] - c["value"]) <= atol + rtol * abs(c["value"]):
            fail(f"telemetry card vs CPU: {g['name']} {g['labels']} "
                 f"{g['value']!r} on the card, {c['value']!r} on the CPU")
        worst = max(worst, abs(g["value"] - c["value"])
                    / max(abs(c["value"]), 1e-30))
    alerts = {w: [(a["rule"], a["round"], a["kind"], a["severity"],
                   a["signal"]) for a in t.health.alerts()]
              for w, t in tels.items()}
    if alerts["cuda"] != alerts["cpu"] or not alerts["cuda"] or any(
            sorted(a) != sorted(tm.ALERT_KEYS)
            for a in tels["cuda"].health.alerts()):
        fail(f"telemetry card vs CPU: alerts {alerts}")
    sizes = check_bundle("telemetry card vs CPU", tels["cuda"],
                         hists["cuda"], run_cfg, fleet)
    print(f"[telemetry] card vs CPU, 3-device flat 2-round run: "
          f"{len(recs['cuda'])} metric records, names and labels exact; "
          f"{len(alerts['cuda'])} alerts identical, the card's bundle "
          f"lines {json.dumps(sizes)}; learning.* values "
          f"within tolerance, largest relative difference {worst!r}",
          flush=True)


def telemetry_phase(main_counts: dict, n_rho: int,
                    n_levels: int) -> tuple[dict, dict]:
    """Phase 9: a telemetry session on the card (see the module
    docstring).  Returns each telemetry-on run's launches and the timed
    host wall times."""
    import statistics
    import tempfile

    import torch
    from repro_torch import telemetry as tm
    from repro_torch.fleet import (AvailabilityConfig, BatteryConfig,
                                   FleetDynamicsConfig)
    from repro_torch.kernels import ops
    from repro_torch.mobility import MobilityConfig
    from repro_torch.orchestrator.policies import OrchestratorConfig
    from repro_torch.sysmodel.population import FleetConfig
    from repro_torch.topology import BackhaulConfig, TopologyConfig
    from repro_torch.train.fl_loop import FLRunConfig, run_fl
    from repro_torch.utils.pytree import tree_leaves

    cfg = FLRunConfig(rounds=3, n_train=1536, n_test=384, eval_every=1,
                      seed=0, use_planner=True)
    flat = FleetConfig(n_devices=N_DEVICES)
    hier = FleetConfig(n_devices=N_DEVICES, topology=TopologyConfig(
        kind="hier", n_cells=N_CELLS,
        backhaul=BackhaulConfig(codec="int8", error_feedback=True)))
    fedbuff = FleetConfig(
        n_devices=N_DEVICES, dynamics=FleetDynamicsConfig(
            availability=AvailabilityConfig(kind="markov", seed=0,
                                            mean_on_s=30.0,
                                            mean_off_s=15.0),
            battery=BatteryConfig(capacity_j=30.0, recharge_w=0.2, seed=0)),
        mobility=MobilityConfig(kind="gauss_markov", seed=0))
    fb_orch = OrchestratorConfig(policy="fedbuff", buffer_size=8)
    launched = {}

    def session(**kw):
        tel = tm.Telemetry(**kw)
        tel.health = tm.HealthEngine(tm.DEFAULT_RULES)
        return tel

    def run(fleet, tel=None, orch=None, run_cfg=cfg):
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        hist = run_fl(run_cfg, fleet, orch, device="cuda", telemetry=tel)
        torch.cuda.synchronize()
        return hist, ops.launch_counts(), time.perf_counter() - t0

    # the default cuDNN algorithms: two runs of one configuration
    a, _, _ = run(flat)
    b, _, _ = run(flat)
    drift = max(float((x - y).abs().max()) for x, y in zip(
        tree_leaves(a.final_params), tree_leaves(b.final_params)))
    print(f"[telemetry] default cuDNN algorithms, two flat runs, telemetry "
          f"off: final parameters differ by up to {drift!r}; test losses "
          f"{[r.test_loss for r in a.rounds]} vs "
          f"{[r.test_loss for r in b.rounds]}; phase 9 compares runs "
          f"under cuDNN's deterministic algorithms", flush=True)

    walls = {}
    with deterministic_cudnn():
        # (a) the flat main path and (b) the 4-cell int8 + EF hierarchy:
        # on against off, then timed off/on alternately
        for key, fleet, hier_path in (("9a flat", flat, False),
                                      ("9b hier int8 EF", hier, True)):
            off, c_off, _ = run(fleet)
            tel = session()
            on, c_on, _ = run(fleet, tel)
            same_run(key, on, off)
            want = expected_launches(cfg, off, n_rho, n_levels, hier_path)
            main = main_counts["hier" if hier_path else "flat"]
            if not c_on == c_off == want == main:
                fail(f"{key}: launched {json.dumps(c_on)} with telemetry "
                     f"on, {json.dumps(c_off)} off, expected "
                     f"{json.dumps(want)}, phase 4 {json.dumps(main)}")
            launched[key] = c_on
            sizes = check_bundle(key, tel, on, cfg, fleet)
            reg = tel.registry
            for r in on.rounds:
                devices = reg.label_values("dispatch.latency_s", "device")
                live = [d for d in devices if reg.value(
                    "learning.update_norm", device=d, round=r.round)
                    is not None]
                if len(live) != r.n_clients + r.n_dropped:
                    fail(f"{key} round {r.round}: learning gauges for "
                         f"{len(live)} devices, {r.n_clients + r.n_dropped} "
                         f"trained")
                for d in live:
                    e = [reg.value("learning.error_energy", device=d,
                                   round=r.round, phase=p)
                         for p in ("shrink", "sparsify", "quantize")]
                    tot = reg.value("learning.error_total", device=d,
                                    round=r.round)
                    if None in e or tot is None \
                            or not abs(sum(e) - tot) <= 1e-5 * abs(tot):
                        fail(f"{key} round {r.round} device {d}: stage "
                             f"energies {e} against e_total {tot}")
                if hier_path:
                    cells = [c for c in range(N_CELLS) if reg.value(
                        "learning.cell_divergence", cell=c, round=r.round)
                        is not None]
                    res = [reg.value("learning.ef_residual_energy", cell=c,
                                     round=r.round) for c in cells]
                    if len(cells) != r.n_cells_reporting \
                            or r.round >= 1 and not all(
                                e is not None and e > 0 for e in res):
                        fail(f"{key} round {r.round}: cell divergence for "
                             f"cells {cells} of {r.n_cells_reporting} "
                             f"reporting, EF residual energies {res}")
            per = {"on": [], "off": []}
            rec = []
            for _ in range(3):
                per["off"].append(run(fleet)[2])
                with timing_recorder(rec):
                    per["on"].append(run(fleet, session())[2])
            walls[key] = {k: statistics.median(v) for k, v in per.items()}
            rec_ms = sum(rec) / 3 / cfg.rounds * 1e3
            walls[key]["recorder_ms_per_round"] = rec_ms
            walls[key]["recorder_share"] = \
                rec_ms / (walls[key]["on"] / cfg.rounds * 1e3)
            print(f"[telemetry] {key}: telemetry on = off bit for bit; "
                  f"launches {json.dumps({k: v for k, v in c_on.items() if v})}"
                  f"; bundle lines {json.dumps(sizes)}; alerts "
                  f"{len(tel.health.alerts())}; 3-round host wall time, "
                  f"median of 3 alternating: off {walls[key]['off']:.4f} s, "
                  f"on {walls[key]['on']:.4f} s (runs off "
                  f"{[round(x, 4) for x in per['off']]}, on "
                  f"{[round(x, 4) for x in per['on']]}); learning recorder "
                  f"{rec_ms:.3f} ms of host time a round, "
                  f"{walls[key]['recorder_share']:.4f} of the round",
                  flush=True)
            if hier_path:
                print(f"[telemetry] {key}: learning.ef_residual_energy by "
                      f"(cell, round) "
                      f"{[(c, r.round, reg.value('learning.ef_residual_energy', cell=c, round=r.round)) for r in on.rounds for c in range(N_CELLS)]}",
                      flush=True)

        # (c) dynamic fedbuff (phase 8d's configuration)
        off, c_off, _ = run(fedbuff, orch=fb_orch)
        tel = session()
        on, c_on, _ = run(fedbuff, tel, orch=fb_orch)
        same_run("9c dynamic fedbuff", on, off)
        if c_on != c_off:
            fail(f"9c dynamic fedbuff: launched {json.dumps(c_on)} on, "
                 f"{json.dumps(c_off)} off")
        launched["9c dynamic fedbuff"] = c_on
        inst = {}
        for e in tel.sink.instants:
            inst[e.name] = inst.get(e.name, 0) + 1
        ev = {}
        for e in on.trace:
            ev[e[2]] = ev.get(e[2], 0) + 1
        want = {"CHURN": ev.get("churn", 0), "RETRY": ev.get("retry", 0),
                "BUFFER_MERGE": len(on.rounds)}
        got = {k: inst.get(k, 0) for k in want}
        if got != want or not all(want.values()):
            fail(f"9c dynamic fedbuff: instants {got}, events {want}")
        print(f"[telemetry] 9c dynamic fedbuff: on = off bit for bit; "
              f"instants {json.dumps(inst)} match the trace's events",
              flush=True)

        # (d) (a) with a rollup policy past its threshold and half the
        # device tracks sampled
        tel = tm.Telemetry(rollup=tm.RollupPolicy(device_threshold=8),
                           trace_sample=0.5)
        on, c_on, _ = run(flat, tel)
        off, _, _ = run(flat)
        same_run("9d rollup and sampling", on, off)
        if c_on != main_counts["flat"] or not tel.registry.rollup_active:
            fail(f"9d rollup and sampling: launched {json.dumps(c_on)}, "
                 f"rollup active {tel.registry.rollup_active}")
        tracks = [t for t in tel.sink.tracks() if t.startswith("device/")]
        if not 0 < len(tracks) < N_DEVICES or not all(
                tm.sampled(0, int(t.split("/")[1]), 0.5) for t in tracks):
            fail(f"9d rollup and sampling: device tracks {tracks}")
        print(f"[telemetry] 9d rollup (threshold 8) and sampling (0.5): on "
              f"= off bit for bit; device tracks kept {tracks}", flush=True)

    # (e) one round under the torch profiler
    with tempfile.TemporaryDirectory() as tmp:
        tel = tm.Telemetry(tmp, torch_profile=True)
        run(flat, tel, run_cfg=dataclasses.replace(cfg, rounds=1))
        path = os.path.join(tmp, "torch_profile", "trace.json")
        with open(path) as f:
            names = {e["name"] for e in json.load(f)["traceEvents"]
                     if e.get("cat") == "kernel"}
    found = {k: sorted(n[:60] for n in names if k in n)
             for k in ("fused_vec4_kernel", "aio_kernel")}
    if not all(found.values()):
        fail(f"9e profiler: kernel events {sorted(names)[:20]}; expected "
             f"the port's #5 and #6")
    print(f"[telemetry] 9e torch profiler, 1 round: {len(names)} distinct "
          f"CUDA kernels in the Chrome trace, among them {found}",
          flush=True)
    return launched, walls


def main() -> None:
    try:
        import torch
    except ImportError as e:
        fail(f"PyTorch is not importable: {e}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a "
             "CUDA card")
    try:
        from repro_torch.core import compression
        from repro_torch.fleet import (AvailabilityConfig, BatteryConfig,
                                       FleetDynamicsConfig)
        from repro_torch.kernels import (aio_agg, build, fused_compress,
                                         ops, quantize, ref, sparsify)
        from repro_torch.mobility import HandoverConfig, MobilityConfig
        from repro_torch.orchestrator.policies import OrchestratorConfig
        from repro_torch.orchestrator.runner import run_orchestrated
        from repro_torch.sysmodel.population import FleetConfig
        from repro_torch.topology import TopologyConfig, payload_bits
        from repro_torch.train.fl_loop import FLRunConfig, run_fl
        from repro_torch.utils.pytree import tree_leaves
    except ImportError as e:
        fail(f"the port is not importable beside this script: {e}")
    for mod in ("jax", "repro"):
        if mod in sys.modules:
            fail(f"{mod} was imported")

    dev = torch.device("cuda")
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}",
          flush=True)

    # ---------------------------------------------------------------- 1
    t0 = time.perf_counter()
    built = build.build_all()
    print(f"[build] nvcc built {built} in {time.perf_counter() - t0:.2f} s",
          flush=True)
    for name, log in build.BUILD_LOGS.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")

    # ---------------------------------------------------------------- 2
    gen = torch.Generator(device=dev).manual_seed(0)
    n = sum(math.prod(s) for s in FMNIST_SHAPES)
    vec = torch.randn(n, generator=gen, device=dev) * 1e-2
    rand = torch.rand(n, generator=gen, device=dev)
    views = compression._leaf_views(vec, FMNIST_SHAPES)
    rviews = compression._leaf_views(rand, FMNIST_SHAPES)
    K = sum(x.shape[0] for x in views)
    checks = {}

    def check_rows(name, kernel, plain, rtol):
        err = 0.0
        for x in views:
            got, want = kernel(x), plain(x)
            torch.testing.assert_close(got, want, rtol=rtol, atol=0)
            err = max(err, float((got - want).abs().max()))
        checks[name] = err

    check_rows("kernel_sumsq", sparsify.kernel_sumsq, ref.kernel_sumsq_ref,
               1e-5)
    check_rows("kernel_l2", sparsify.kernel_l2, ref.kernel_l2_ref, 1e-5)
    # the main path's unit: one flat call over the whole update, within
    # rtol 1e-5 of the plain version and bitwise the same on a second call
    for name, kernel, plain in (
            ("kernel_sumsq", sparsify.kernel_sumsq_flat,
             ref.kernel_sumsq_flat_ref),
            ("kernel_l2", sparsify.kernel_l2_flat, ref.kernel_l2_flat_ref)):
        got, want = kernel(vec, FMNIST_SHAPES), plain(vec, FMNIST_SHAPES)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=0)
        if not torch.equal(got, kernel(vec, FMNIST_SHAPES)):
            fail(f"{name}: two flat calls on one input differ")
        checks[name] = max(checks[name], float((got - want).abs().max()))
    norms = sparsify.kernel_l2_flat(vec, FMNIST_SHAPES)
    print(f"[check] flat norms over {len(FMNIST_SHAPES)} leaves, K = {K}: "
          f"rtol 1e-5 of the plain version, bitwise stable across two calls",
          flush=True)
    thr = compression.sparsify_threshold(norms, 0.8)
    thr_f = float(thr)
    mask = compression._element_mask((norms >= thr).float(), FMNIST_SHAPES)
    u_min, u_max = compression.masked_range(vec, mask)
    scal = (float(thr), float(u_min), float(u_max), 64.0)
    fused_err, k0 = 0.0, 0
    for x, r in zip(views, rviews):
        nk = norms[k0:k0 + x.shape[0]]
        q, lvl = fused_compress.fused_sparsify_quantize(x, nk, *scal, r)
        qr, lr = ref.fused_sparsify_quantize_ref(x, nk, *scal, r)
        if not torch.equal(lvl, lr):
            fail(f"fused_sparsify_quantize: level indices differ at "
                 f"{int((lvl != lr).sum())} elements")
        if not torch.equal(q != 0, qr != 0):
            fail("fused_sparsify_quantize: the kept support differs")
        torch.testing.assert_close(q, qr, rtol=1e-6, atol=0)
        fused_err = max(fused_err, float((q - qr).abs().max()))
        k0 += x.shape[0]
    # the main path's unit: one launch over the whole flat update, also on
    # leaves that start off a 16-byte boundary and on planes one element
    # off one (the scalar loop)
    def check_fused_flat(x, r, shapes, nk, sc, label):
        before = fused_compress.launches["fused_sparsify_quantize"]
        q, lvl = fused_compress.fused_sparsify_quantize_flat(x, shapes, nk,
                                                             *sc, r)
        if fused_compress.launches["fused_sparsify_quantize"] != before + 1:
            fail(f"fused_sparsify_quantize_flat ({label}) is not one launch")
        qr, lr = ref.fused_sparsify_quantize_flat_ref(x, shapes, nk, *sc, r)
        if not torch.equal(lvl, lr):
            fail(f"fused_sparsify_quantize_flat ({label}): level indices "
                 f"differ at {int((lvl != lr).sum())} elements")
        if not torch.equal(q != 0, qr != 0):
            fail(f"fused_sparsify_quantize_flat ({label}): the kept support "
                 f"differs")
        torch.testing.assert_close(q, qr, rtol=1e-6, atol=0)
        return float((q - qr).abs().max())

    fused_err = max(fused_err, check_fused_flat(
        vec, rand, FMNIST_SHAPES, norms, scal, "fmnist-cnn"))
    n_mis = sum(math.prod(s) for s in MISALIGNED_SHAPES)
    for off in (0, 1):
        xs = torch.randn(n_mis + off, generator=gen, device=dev)[off:]
        rs = torch.rand(n_mis + off, generator=gen, device=dev)[off:]
        nk = sparsify.kernel_l2_flat(xs, MISALIGNED_SHAPES)
        sc = (float(nk.median()), 1e-4, float(xs.abs().max()), 37.25)
        fused_err = max(fused_err, check_fused_flat(
            xs, rs, MISALIGNED_SHAPES, nk, sc,
            f"leaves off 16 B, plane offset {off}"))
    checks["fused_sparsify_quantize"] = fused_err
    print(f"[check] fused_sparsify_quantize: one launch over the flat update "
          f"(fmnist-cnn, and leaves {MISALIGNED_SHAPES} on aligned and "
          f"misaligned planes): levels and support exact, values rtol 1e-6",
          flush=True)

    # threshold_apply: the planner's one launch over the flat update, at the
    # fmnist-cnn shapes and on leaves off a 16-byte boundary on aligned and
    # misaligned planes, then the single-view call on every leaf view; the
    # masked vector and the keep vector exact
    def check_threshold_flat(x, shapes, nk, t, label):
        before = sparsify.launches["threshold_apply"]
        got, kp = sparsify.threshold_apply_flat(x, shapes, nk, t)
        if sparsify.launches["threshold_apply"] != before + 1:
            fail(f"threshold_apply_flat ({label}) is not one launch")
        want, want_kp = ref.threshold_apply_flat_ref(x, shapes, nk, t)
        if not (torch.equal(got, want) and torch.equal(kp, want_kp)):
            fail(f"threshold_apply_flat ({label}) differs from its plain "
                 f"version")
        return float((got - want).abs().max())

    thr_err = check_threshold_flat(vec, FMNIST_SHAPES, norms, thr_f,
                                   "fmnist-cnn")
    for off in (0, 1):
        xs = torch.randn(n_mis + off, generator=gen, device=dev)[off:]
        nk = sparsify.kernel_l2_flat(xs, MISALIGNED_SHAPES)
        thr_err = max(thr_err, check_threshold_flat(
            xs, MISALIGNED_SHAPES, nk, float(nk.median()),
            f"leaves off 16 B, plane offset {off}"))
    k0 = 0
    for x in views:
        nk = norms[k0:k0 + x.shape[0]]
        got, kp = sparsify.threshold_apply(x, nk, thr_f)
        want, want_kp = ref.threshold_mask_ref(x, nk, thr_f)
        if got.stride() != x.stride() or not (torch.equal(got, want)
                                              and torch.equal(kp, want_kp)):
            fail("threshold_apply (one view) differs from its plain version")
        thr_err = max(thr_err, float((got - want).abs().max()))
        k0 += x.shape[0]
    checks["threshold_apply"] = thr_err
    masked, _ = sparsify.threshold_apply_flat(vec, FMNIST_SHAPES, norms, thr_f)
    print(f"[check] threshold_apply: one launch over the flat update "
          f"(fmnist-cnn, and leaves {MISALIGNED_SHAPES} on aligned and "
          f"misaligned planes) and per leaf view: exact", flush=True)

    # prob_quantize over the flat masked vector (the planner's call), at
    # N = 1..7 (the N % 4 tail alone and with a body) and on planes one
    # element off a 16-byte boundary (the scalar loop)
    def check_quantize(args, label):
        before = quantize.launches["prob_quantize"]
        q4, l4 = quantize.prob_quantize(*args)
        if quantize.launches["prob_quantize"] != before + 1:
            fail(f"prob_quantize ({label}) is not one launch")
        q4r, l4r = ref.quantize_ref(*args)
        if not torch.equal(l4, l4r):
            fail(f"prob_quantize ({label}): level indices differ at "
                 f"{int((l4 != l4r).sum())} elements")
        torch.testing.assert_close(q4, q4r, rtol=1e-6, atol=0)
        return float((q4 - q4r).abs().max())

    qargs = (masked, mask, float(u_min), float(u_max), 64.0, rand)
    quant_err = check_quantize(qargs, f"N = {n}")
    for k in range(1, 8):
        v = torch.randn(k, generator=gen, device=dev) * 1e-2
        m = (torch.rand(k, generator=gen, device=dev) > 0.3).float()
        quant_err = max(quant_err, check_quantize(
            (v, m, 1e-4, float(v.abs().max()), 37.25,
             torch.rand(k, generator=gen, device=dev)), f"N = {k}"))
    shifted = [torch.empty(n + 1, device=dev)[1:].copy_(t)
               for t in (masked, mask, rand)]
    quant_err = max(quant_err, check_quantize(
        (shifted[0], shifted[1], *qargs[2:5], shifted[2]), "misaligned"))
    checks["prob_quantize"] = quant_err
    print(f"[check] prob_quantize at N = {n}, N = 1..7 and on misaligned "
          f"planes: levels exact, values rtol 1e-6", flush=True)

    # the streaming pair, in place, bit for bit, at full N, at N = 1..7
    # (the N % 4 tail alone and with a body) and on a plane one element off
    # a 16-byte boundary (the scalar loop)
    num = torch.randn(n, generator=gen, device=dev) * 1e-3
    den = torch.rand(n, generator=gen, device=dev)
    upd = torch.randn(n, generator=gen, device=dev) * 1e-2
    msk = (torch.rand(n, generator=gen, device=dev) > 0.4).float()
    num_b, den_b = upd.clone(), msk.clone()

    def check_stream(kernel, planes, extra, label):
        a_side = [t.data_ptr() for t in planes[:2]]
        want = getattr(ref, f"{kernel}_ref")(*planes, *extra)
        getattr(aio_agg, kernel)(*planes, *extra)
        if [t.data_ptr() for t in planes[:2]] != a_side:
            fail(f"{kernel} ({label}) did not update in place")
        if not (torch.equal(planes[0], want[0])
                and torch.equal(planes[1], want[1])):
            fail(f"{kernel} ({label}) differs from its plain version")
        return max(float((planes[0] - want[0]).abs().max()),
                   float((planes[1] - want[1]).abs().max()))

    for kernel, b_side, extra in (("aio_absorb", (upd, msk), (3.7184,)),
                                  ("aio_merge", (num_b, den_b), ())):
        err = check_stream(kernel, (num, den, *b_side), extra, f"N = {n}")
        for k in range(1, 8):
            small_planes = tuple(torch.randn(k, generator=gen, device=dev)
                                 for _ in range(4))
            err = max(err, check_stream(kernel, small_planes, extra,
                                        f"N = {k}"))
        shifted = torch.randn(n + 1, generator=gen, device=dev)[1:]
        err = max(err, check_stream(kernel, (shifted, den.clone(), *b_side),
                                    extra, "misaligned"))
        checks[kernel] = err
    print(f"[check] aio_absorb and aio_merge bit for bit and in place at "
          f"N = {n}, N = 1..7 and on a misaligned plane", flush=True)

    def check_aggregate(u, m, w, label):
        before = aio_agg.launches["aio_aggregate"]
        agg = aio_agg.aio_aggregate(u, m, w)
        if aio_agg.launches["aio_aggregate"] != before + 1:
            fail(f"aio_aggregate ({label}) is not one launch")
        agg_ref = ref.aio_aggregate_ref(u, m, w)
        torch.testing.assert_close(agg, agg_ref, rtol=1e-6, atol=0)
        return float((agg - agg_ref).abs().max())

    u = torch.randn(N_DEVICES, n, generator=gen, device=dev) * 1e-2
    m = (torch.rand(N_DEVICES, n, generator=gen, device=dev) > 0.4).float()
    w = theorem1_weights(dev)
    checks["aio_aggregate"] = check_aggregate(u, m, w, "fmnist-cnn")
    torch.cuda.synchronize()
    print(f"[check] kernels against plain versions, max abs err: "
          f"{json.dumps(checks)}", flush=True)

    # ---------------------------------------------------------------- 3
    small = FLRunConfig(rounds=2, n_train=128, n_test=64, eval_every=1,
                        lr=0.1, seed=3, use_planner=False)
    flat3 = FleetConfig(n_devices=3)
    small_runs = {
        "flat": (small, flat3),
        "hier": (small, FleetConfig(n_devices=4, topology=TopologyConfig(
            kind="hier", n_cells=2))),
        "flat qsgd": (dataclasses.replace(small, method="qsgd"), flat3),
        "flat uveqfed": (dataclasses.replace(small, method="uveqfed"),
                         flat3)}
    for kind, (run_cfg, fleet) in small_runs.items():
        logs, diffs = small_run_pair(run_cfg, fleet, 7)
        swapped = False
        for c, g, d in zip(logs["cpu"], logs["cuda"], diffs):
            if (c.mean_alpha, c.mean_gain, c.n_clients, c.n_cells_reporting,
                    c.backhaul_bits) != (g.mean_alpha, g.mean_gain,
                                         g.n_clients, g.n_cells_reporting,
                                         g.backhaul_bits):
                fail(f"small {kind} run: strategies or cells differ in "
                     f"round {c.round}")
            if c.round == 0 and (d["swaps"] > TOPK_FIRST_SWAPS
                                 or d["near"] > TOPK_FIRST_NEAR):
                fail(f"small {kind} run: in round 0 an update's top-k masks "
                     f"differ between the card and the CPU in {d['swaps']} "
                     f"elements, up to {d['near']} of the threshold away "
                     f"(limits {TOPK_FIRST_SWAPS}, {TOPK_FIRST_NEAR})")
            # from the first round in which a top-k mask differs, the
            # aggregate differs by whole kept values
            swapped = swapped or d["swaps"] > 0
            loss_rtol = TOPK_LOSS_RTOL if swapped else 1e-3
            for f, rtol in (("comm_bits", 1e-3), ("latency_s", 1e-3),
                            ("energy_j", 1e-3), ("test_loss", loss_rtol)):
                a, b = getattr(c, f), getattr(g, f)
                if not abs(a - b) <= rtol * abs(a):
                    fail(f"small {kind} run: {f} {b} on the card vs {a} on "
                         f"the CPU in round {c.round} (rtol {rtol})")
            if abs(c.test_acc - g.test_acc) > 0.05:
                fail(f"small {kind} run: accuracy {g.test_acc} vs "
                     f"{c.test_acc}")
        print(f"[agree] {kind} {fleet.n_devices}-device 2-round "
              f"run, card vs CPU: comm_bits "
              f"{[r.comm_bits for r in logs['cuda']]} vs "
              f"{[r.comm_bits for r in logs['cpu']]}; test_loss "
              f"{[r.test_loss for r in logs['cuda']]} vs "
              f"{[r.test_loss for r in logs['cpu']]}; cells reporting "
              f"{[r.n_cells_reporting for r in logs['cuda']]}; top-k "
              f"differences per round {json.dumps(diffs)}", flush=True)

    # the small fedbuff run: the timeline reads planned costs only, so the
    # trace, the staleness and the in-flight peak are exact
    fb = {where: run_orchestrated(
        small, flat3, OrchestratorConfig(policy="fedbuff", buffer_size=2,
                                         max_wallclock_s=30.0),
        device=where, uniforms=CpuDrawnUniforms(7, where))
        for where in ("cpu", "cuda")}
    if fb["cpu"].trace != fb["cuda"].trace \
            or fb["cpu"].peak_inflight != fb["cuda"].peak_inflight:
        fail("small fedbuff run: the event trace or the in-flight peak "
             "differs between the card and the CPU")
    if len(fb["cpu"].rounds) < 2:
        fail(f"small fedbuff run: {len(fb['cpu'].rounds)} merges")
    for c, g in zip(fb["cpu"].rounds, fb["cuda"].rounds):
        if (c.n_clients, c.mean_staleness, c.max_staleness,
                c.n_stale_dropped) != (g.n_clients, g.mean_staleness,
                                       g.max_staleness, g.n_stale_dropped):
            fail(f"small fedbuff run: merge {c.round}'s clients or "
                 f"staleness differ between the card and the CPU")
        for f in ("comm_bits", "energy_j", "test_loss"):
            a, b = getattr(c, f), getattr(g, f)
            if not abs(a - b) <= 1e-3 * abs(a):
                fail(f"small fedbuff run: {f} {b} on the card vs {a} on "
                     f"the CPU in merge {c.round} (rtol 1e-3)")
    print(f"[agree] fedbuff 3-device run (buffer 2, 30 s), card vs CPU: "
          f"{len(fb['cuda'].trace)} events, trace exact; staleness "
          f"{[r.mean_staleness for r in fb['cuda'].rounds]}; peak in "
          f"flight {fb['cuda'].peak_inflight}; test_loss "
          f"{[r.test_loss for r in fb['cuda'].rounds]} vs "
          f"{[r.test_loss for r in fb['cpu'].rounds]}", flush=True)

    # a dynamic flat fleet and a mobile hierarchy, card vs CPU
    dynamic_pair("dynamic 4-device flat run (Markov, battery, gain at "
                 "0.5)", small, FleetConfig(
                     n_devices=4, dynamics=FleetDynamicsConfig(
                         availability=AvailabilityConfig(
                             kind="markov", seed=1, mean_on_s=30.0,
                             mean_off_s=15.0),
                         battery=BatteryConfig(capacity_j=30.0,
                                               recharge_w=0.2, seed=0),
                         selection="gain", participation=0.5)))
    dynamic_pair("mobile 4-device 2-cell run (random waypoint, nearest "
                 "handover)", small, FleetConfig(
                     n_devices=4, topology=TopologyConfig(
                         kind="hier", n_cells=2, handover=HandoverConfig(
                             "nearest", margin_m=5.0)),
                     mobility=MobilityConfig(kind="random_waypoint",
                                             seed=9,
                                             speed_range=(30.0, 60.0))))

    # ---------------------------------------------------------------- 4
    cfg = FLRunConfig(rounds=3, n_train=1536, n_test=384, eval_every=1,
                      seed=0, use_planner=True)
    paths = {
        "flat": FleetConfig(n_devices=N_DEVICES),
        "hier": FleetConfig(n_devices=N_DEVICES, topology=TopologyConfig(
            kind="hier", n_cells=N_CELLS))}
    expected = {
        "flat": {k for k in ops.launch_counts()
                 if k not in ("aio_absorb", "aio_merge")},
        "hier": {k for k in ops.launch_counts() if k != "aio_aggregate"}}
    grids = inspect.signature(compression.BetaPlanner.fit).parameters
    n_rho = len(grids["rho_grid"].default)
    n_levels = len(grids["level_grid"].default)
    counts, walls = {}, {}
    for kind, fleet in paths.items():
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        hist = run_fl(cfg, fleet, device="cuda")
        torch.cuda.synchronize()
        walls[kind] = time.perf_counter() - t0
        counts[kind] = ops.launch_counts()
        print(f"[main] {kind}: run_fl fmnist-cnn, {N_DEVICES} devices, "
              f"{cfg.rounds} rounds, n_train {cfg.n_train}, planner on: "
              f"{walls[kind]:.3f} s on the host clock, first round's "
              f"planner fit and warm-up included", flush=True)
        for r in hist.rounds:
            print(f"[main] {kind} round {r.round}: n_clients={r.n_clients} "
                  f"mean_alpha={r.mean_alpha:.4f} "
                  f"mean_beta={r.mean_beta:.6f} comm_bits={r.comm_bits:.1f} "
                  f"latency_s={r.latency_s:.4f} energy_j={r.energy_j:.4f} "
                  f"n_cells_reporting={r.n_cells_reporting} "
                  f"backhaul_bits={r.backhaul_bits:.1f} "
                  f"test_acc={r.test_acc} test_loss={r.test_loss}")
        print(f"[main] {kind} launches: {json.dumps(counts[kind])}",
              flush=True)
        launched = {k for k, v in counts[kind].items() if v > 0}
        if launched != expected[kind]:
            fail(f"the {kind} path launched {sorted(launched)}, expected "
                 f"{sorted(expected[kind])}")
        # one norm call per compressed update (every live device's, kept
        # or dropped) and one for the planner's probe
        n_norm_calls = sum(r.n_clients + r.n_dropped for r in hist.rounds) + 1
        if not (counts[kind]["kernel_l2"] == counts[kind]["kernel_sumsq"]
                == n_norm_calls):
            fail(f"{kind}: kernel_l2 launched {counts[kind]['kernel_l2']} "
                 f"times, expected one per compressed update and planner "
                 f"probe, {n_norm_calls}")
        print(f"[main] {kind}: kernel_l2 launched {n_norm_calls} times, once "
              f"per compressed update and planner probe", flush=True)
        # the fused step: one launch per compressed update, kept or dropped
        n_updates = n_norm_calls - 1
        if counts[kind]["fused_sparsify_quantize"] != n_updates:
            fail(f"{kind}: fused_sparsify_quantize launched "
                 f"{counts[kind]['fused_sparsify_quantize']} times, expected "
                 f"one per compressed update, {n_updates}")
        print(f"[main] {kind}: fused_sparsify_quantize launched {n_updates} "
              f"times, once per compressed update", flush=True)
        # the planner's fit: #3 once per rho, #4 once per (rho, L)
        if (counts[kind]["threshold_apply"], counts[kind]["prob_quantize"]) \
                != (n_rho, n_rho * n_levels):
            fail(f"{kind}: threshold_apply launched "
                 f"{counts[kind]['threshold_apply']} and prob_quantize "
                 f"{counts[kind]['prob_quantize']} times, expected one per "
                 f"planner rho ({n_rho}) and one per (rho, L) "
                 f"({n_rho * n_levels})")
        print(f"[main] {kind}: threshold_apply launched {n_rho} times, once "
              f"per planner rho; prob_quantize {n_rho * n_levels} times, "
              f"once per (rho, L)", flush=True)
        if not all(r.test_loss is not None and math.isfinite(r.test_loss)
                   for r in hist.rounds):
            fail(f"{kind}: a round's test loss is not finite")
        final = tree_leaves(hist.final_params)
        if [tuple(t.shape) for t in final] != FMNIST_SHAPES:
            fail(f"{kind}: final parameter shapes "
                 f"{[tuple(t.shape) for t in final]}")
        if not all(bool(torch.isfinite(t).all()) and t.device.type == "cuda"
                   for t in final):
            fail(f"{kind}: final parameters are not finite CUDA tensors")
        if kind == "hier":
            ship = payload_bits(n, len(FMNIST_SHAPES), "f32")
            for r in hist.rounds:
                if r.n_cells_reporting != N_CELLS \
                        or r.backhaul_bits != N_CELLS * ship:
                    fail(f"hier round {r.round}: {r.n_cells_reporting} "
                         f"cells reporting, {r.backhaul_bits} backhaul "
                         f"bits; expected {N_CELLS} and {N_CELLS * ship}")
            if counts[kind]["aio_absorb"] != sum(r.n_clients
                                                 for r in hist.rounds):
                fail("hier: aio_absorb did not launch once per accepted "
                     "update")
            n_merges = sum(r.n_cells_reporting - 1 for r in hist.rounds)
            if counts[kind]["aio_merge"] != n_merges:
                fail(f"hier: aio_merge launched "
                     f"{counts[kind]['aio_merge']} times, expected one per "
                     f"extra reporting cell, {n_merges}")
            print(f"[main] hier: aio_merge launched {n_merges} times, once "
                  f"per extra reporting cell", flush=True)
    launches = dict(counts["flat"], aio_absorb=counts["hier"]["aio_absorb"],
                    aio_merge=counts["hier"]["aio_merge"])

    # ---------------------------------------------------------------- 5
    def per_leaf(fn):
        return lambda: [fn(x) for x in views]

    def tensors_in(obj):
        if isinstance(obj, torch.Tensor):
            return [obj]
        if isinstance(obj, (tuple, list)):
            return [t for o in obj for t in tensors_in(o)]
        return []

    def footprint_mb(r):
        """The bytes of the distinct storages the unit reads (its
        operands) and writes (in place, or what it returns)."""
        storages = {}
        for t in tensors_in([r["operands"], r["unit"]()]):
            st = t.untyped_storage()
            storages[st.data_ptr()] = st.nbytes()
        return sum(storages.values()) / 1e6

    num_a, den_a = num.clone(), den.clone()
    ones = torch.ones_like(msk)
    # The plain versions take their scalars as 0-d tensors on the card
    # (the same float32 values the kernels take as arguments): a Python
    # scalar would cost each call a host-to-device copy, which a CUDA
    # graph cannot capture.
    scal_d = tuple(torch.tensor(v, dtype=torch.float32, device=dev)
                   for v in scal)
    qargs_d = (masked, mask, u_min, u_max, scal_d[3], rand)
    w_d = torch.tensor(0.5, dtype=torch.float32, device=dev)
    # Each row: the main path's unit of work through the kernel, the
    # tensors it reads (its outputs are what it returns), its plain
    # version, the one PyTorch call (or per-leaf calls) that computes the
    # same function where there is one, the bytes the unit must move and
    # the float32 operations it does.
    rows = [
        dict(name="kernel_sumsq", source="sparsify.cu",
             operands=(vec,),
             replaces="src/repro/kernels/sparsify.py:36",
             unit=lambda: sparsify.kernel_sumsq_flat(vec, FMNIST_SHAPES),
             plain=lambda: ref.kernel_sumsq_flat_ref(vec, FMNIST_SHAPES),
             library=per_leaf(lambda x: torch.einsum("kc,kc->k", x, x)),
             library_name="8 x einsum('kc,kc->k')",
             tolerance="rtol 1e-5, bitwise stable", nbytes=4 * n + 4 * K,
             nflops=2 * n),
        dict(name="kernel_l2", source="sparsify.cu",
             operands=(vec,),
             replaces="src/repro/kernels/sparsify.py:58",
             unit=lambda: sparsify.kernel_l2_flat(vec, FMNIST_SHAPES),
             plain=lambda: ref.kernel_l2_flat_ref(vec, FMNIST_SHAPES),
             library=per_leaf(lambda x: torch.linalg.vector_norm(x, dim=1)),
             library_name="8 x linalg.vector_norm",
             tolerance="rtol 1e-5, bitwise stable", nbytes=4 * n + 4 * K,
             nflops=2 * n + K),
        dict(name="fused_sparsify_quantize", source="fused_compress.cu",
             operands=(vec, norms, rand),
             replaces="src/repro/kernels/fused_compress.py:43",
             unit=lambda: fused_compress.fused_sparsify_quantize_flat(
                 vec, FMNIST_SHAPES, norms, *scal, rand),
             plain=lambda: ref.fused_sparsify_quantize_flat_ref(
                 vec, FMNIST_SHAPES, norms, *scal_d, rand),
             library=None, library_name=None,
             tolerance="levels and support exact, values rtol 1e-6",
             nbytes=16 * n + 4 * K, nflops=12 * n),
        dict(name="aio_aggregate", source="aio_agg.cu",
             operands=(u, m, w),
             replaces="src/repro/kernels/aio_agg.py:53",
             unit=lambda: aio_agg.aio_aggregate(u, m, w),
             plain=lambda: ref.aio_aggregate_ref(u, m, w),
             library=None, library_name=None,
             tolerance="rtol 1e-6",
             nbytes=8 * N_DEVICES * n + 4 * N_DEVICES + 4 * n,
             nflops=4 * N_DEVICES * n + n),
        dict(name="threshold_apply", source="sparsify.cu",
             operands=(vec, norms),
             replaces="src/repro/kernels/sparsify.py:70",
             unit=lambda: sparsify.threshold_apply_flat(
                 vec, FMNIST_SHAPES, norms, thr_f),
             plain=lambda: ref.threshold_apply_flat_ref(
                 vec, FMNIST_SHAPES, norms, thr),
             library=None, library_name=None,
             tolerance="exact", nbytes=8 * n + 8 * K, nflops=n),
        dict(name="prob_quantize", source="quantize.cu",
             operands=qargs[:2] + qargs[5:],
             replaces="src/repro/kernels/quantize.py:39",
             unit=lambda: quantize.prob_quantize(*qargs),
             plain=lambda: ref.quantize_ref(*qargs_d),
             library=None, library_name=None,
             tolerance="levels exact, values rtol 1e-6", nbytes=20 * n,
             nflops=12 * n),
        dict(name="aio_absorb", source="aio_agg.cu",
             operands=(num_a, den_a, upd, msk),
             replaces="src/repro/kernels/aio_agg.py:90",
             unit=lambda: aio_agg.aio_absorb(num_a, den_a, upd, msk, 0.5),
             plain=lambda: ref.aio_absorb_ref(num_a, den_a, upd, msk, w_d),
             library=lambda: torch._foreach_addcmul_(
                 [num_a, den_a], [msk, msk], [upd, ones], value=0.5),
             library_name="_foreach_addcmul_ (rounds w*(m*u), not (w*m)*u)",
             tolerance="exact, in place",
             nbytes=24 * n, nflops=4 * n),
        dict(name="aio_merge", source="aio_agg.cu",
             operands=(num_a, den_a, num_b, den_b),
             replaces="src/repro/kernels/aio_agg.py:130",
             unit=lambda: aio_agg.aio_merge(num_a, den_a, num_b, den_b),
             plain=lambda: ref.aio_merge_ref(num_a, den_a, num_b, den_b),
             library=lambda: torch._foreach_add_([num_a, den_a],
                                                 [num_b, den_b]),
             library_name="_foreach_add_",
             tolerance="exact, in place", nbytes=24 * n, nflops=2 * n),
    ]
    kernels = []
    for r in rows:
        b, by = bound_ms(r["nbytes"], r["nflops"])
        lib = r["library"]
        kernels.append(dict(
            name=r["name"], route="cuda",
            source=f"src/repro_torch/kernels/csrc/{r['source']}",
            replaces=r["replaces"], launches=launches[r["name"]],
            max_abs_err=checks[r["name"]], ms=cuda_ms(r["unit"]),
            plain_ms=cuda_ms(r["plain"]), bound_ms=b, bound_by=by,
            library_ms=cuda_ms(lib) if lib else None,
            device_ms=graph_ms(r["unit"]),
            plain_device_ms=graph_ms(r["plain"]),
            library_device_ms=graph_ms(lib) if lib else None,
            library_call=r["library_name"],
            tolerance=r["tolerance"]))
    footprints = [footprint_mb(r) for r in rows]
    for k, mb in zip(kernels, footprints):
        warm = (f"footprint {mb:.1f} MB, "
                + ("within the 50 MB L2" if mb * 1e6 <= L2_BYTES
                   else "beyond the 50 MB L2"))
        below = " (below the HBM bound: L2-resident)" \
            if k["device_ms"] < k["bound_ms"] else ""
        print(f"[time] {k['name']}: kernel {k['ms']:.6f} ms, device "
              f"{k['device_ms']:.6f} ms{below}; plain {k['plain_ms']:.6f} "
              f"ms (device {k['plain_device_ms']:.6f}); library "
              f"{k['library_ms']} ms "
              f"(device {k['library_device_ms']}, {k['library_call']}); "
              f"bound {k['bound_ms']:.6f} ms ({k['bound_by']}); "
              f"{k['launches']} launches on the main path; {warm}")

    print(f"[time] host wall time of the 3-round main-path runs: flat "
          f"{walls['flat']:.3f} s, hier {walls['hier']:.3f} s", flush=True)

    # the beta planner's fit alone, on a probe of the fmnist-cnn shapes (the
    # kernels built and warm from phase 4): host wall time, the launches of
    # #1-#4 it made, and the device-only time of one entropy_bits call (its
    # 65536-bin index_add_ histogram) from CUDA-graph replays, once per
    # (rho, L) probe
    probe, off = {}, 0
    for i, shape in enumerate(FMNIST_SHAPES):
        probe[f"l{i:02d}"] = vec[off:off + math.prod(shape)].view(shape)
        off += math.prod(shape)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    compression.BetaPlanner.fit(probe, rand)
    torch.cuda.synchronize()
    fit_ms = (time.perf_counter() - t0) * 1e3
    fit_launches = {k: v for k, v in ops.launch_counts().items()
                    if k in ("kernel_sumsq", "kernel_l2", "threshold_apply",
                             "prob_quantize")}
    _, l64 = quantize.prob_quantize(*qargs)
    hist_ms = graph_ms(lambda: compression.entropy_bits(
        l64, mask, compression.MAX_LEVELS))
    n_probes = n_rho * n_levels
    print(f"[fit] BetaPlanner.fit on the fmnist-cnn probe ({n_rho} rho x "
          f"{n_levels} L): {fit_ms:.3f} ms of host wall time; launches "
          f"{json.dumps(fit_launches)}; entropy_bits {hist_ms:.6f} ms of "
          f"device time a call (CUDA graph), x {n_probes} probes = "
          f"{hist_ms * n_probes:.3f} ms, {hist_ms * n_probes / fit_ms:.4f} "
          f"of the fit", flush=True)
    table1_phase(card, checks_at=dict(
        fused=check_fused_flat, threshold=check_threshold_flat,
        quantize=check_quantize, aggregate=check_aggregate), n_rho=n_rho,
        n_levels=n_levels)

    # ---------------------------------------------------------------- 7
    by_path = {"4a flat": counts["flat"], "4b hier": counts["hier"],
               **{f"7 {k}": v for k, v in async_phase(n_rho,
                                                      n_levels).items()}}
    # ---------------------------------------------------------------- 8
    by_path.update(fleet_phase(n_rho, n_levels))
    # ---------------------------------------------------------------- 9
    telemetry_card_cpu(small, flat3)
    tel_launched, _ = telemetry_phase(counts, n_rho, n_levels)
    by_path.update(tel_launched)
    for k in kernels:
        k["launches_by_path"] = {path: c[k["name"]]
                                 for path, c in by_path.items()}
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
