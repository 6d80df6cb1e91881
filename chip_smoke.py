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
10. LM serving (``repro_torch.models``, ``launch/serve.py``), with every
    launch counter zeroed before and read after: none of #1-#8 may
    launch.  Full published configs, bf16 parameters from a seeded
    generator on the card:
    (a) card against CPU, float32, reduced qwen2-7b, a grouped-head
        variant (8 q-heads over 2 kv-heads), granite-moe-1b-a400m and
        pixtral-12b (also ``forward_vlm``), one initialisation copied:
        prefill (B=2, 16 tokens), then 8 decode steps teacher-forced
        with the CPU's tokens; ``k_pos`` exact, logits and caches at
        rtol/atol ``SERVE_CARD_CPU_TOL``;
    (b) qwen2-7b (28 layers): serve B=8, a 512-token prompt, 64 greedy
        tokens through the entry point's ``generate`` (prefill ms and
        decode ms a step, medians of 3 runs; tok/s; peak memory; finite
        logits); a 64-token prefill (B=2) against the decode loop over
        it, within ``PREFILL_DECODE_ATOL``; one prefill and 4 decode
        steps under ``torch.profiler``: kernel time (more than the host
        time fails), the device's idle share, the float32 attention's
        and unembedding's shares, the top-level aten ops and the
        device's kernels;
    (c) its alpha 0.5 sub-model: the sorted model against the unsorted
        one within ``SORTED_ATOL`` (argmax agreement printed); the
        sub-model cut by the entry point's ``submodel``, widths
        ``{'mlp': 13396, 'heads': 5}`` (20 heads), the full model
        dropped before it is served at (b)'s shapes; then the same with
        the mlp width rounded to 128;
    (d) ``attend`` at qwen2-7b's head shapes, float32, B=1, S=4096
        (blockwise, plain and ``causal_skip``, without and with a
        1024-token window) within ``ATTN_ATOL`` of ``attention_dense``;
    (e) granite-moe-1b-a400m: serve as (b); the (token, k) assignments
        the 512-token chunk's capacity drops; one decode step through
        ``moe_decode="gather"`` against ``"dispatch"`` within
        ``GATHER_ATOL``;
    (f) pixtral-12b: ``forward_vlm`` (B=1, 1024 patches, S=2048) finite;
        text serve B=4, a 256-token prompt, 32 tokens.
    It prints its wall time.
11. The recurrent and encoder-decoder LMs, with every launch counter
    zeroed just before and read just after: none of #1-#8 may launch.
    Full published configs, no depth cut, bf16 parameters from a seeded
    generator on the card:
    (a) card against CPU, float32, reduced falcon-mamba-7b (a 256-token
        prompt: two scan chunks), recurrentgemma-9b at 5 layers (one
        superblock and a two-layer tail; an 80-token prompt wraps its
        64-slot attention ring) and seamless-m4t-large-v2 (16 tokens),
        one initialisation copied: the forward, the serve path's
        decode-loop prefill, 8 decode steps teacher-forced with the
        CPU's tokens (seamless also ``prefill_encdec_cache``); every
        cache's ``k_pos`` exact, logits and every other cache leaf at
        ``SERVE_CARD_CPU_TOL``;
    (b) falcon-mamba-7b (64 layers, d_inner 8192): ``forward_lm`` at
        B=8, S=512 (ms, the median of 3; peak memory; host and kernel
        ms and the idle share under ``torch.profiler``; the doubling
        scan's and the unembedding's shares of the device time from
        CUDA events around each call, :func:`event_ms`, since the
        profiler can count a range of thousands of kernels twice);
        ``generate`` at B=8, a 128-token prompt
        through the decode-loop prefill and 32 greedy tokens (one run,
        whose prefill is 128 decode steps and whose decode ms is the
        mean of 31: at 70-85 ms a host-bound step, medians of 3 runs
        took the phase to 256 s); the last prompt position's logits from
        ``forward_lm`` against the decode loop's within
        ``SSM_LOOP_ATOL`` (argmax agreement printed); its alpha 0.5
        sub-model as ``launch/serve.submodel`` cuts it, the full model
        dropped, served the same way;
    (c) recurrentgemma-9b (12 superblocks and a 2-layer tail, window
        2048, vocab 256000): as (b), within ``HYBRID_LOOP_ATOL``, also
        the attention's share; no sub-model (no shrinkable group);
    (d) seamless-m4t-large-v2 (24 + 24 layers): ``encode`` at B=2 over
        4096 frames (blockwise attention) and ``forward_encdec`` at
        B=2, S=256 (ms and peak); ``prefill_encdec_cache`` and 32
        teacher-forced ``decode_encdec`` steps against
        ``forward_encdec`` within ``ENCDEC_DECODE_ATOL``; ``generate``
        from zero encoder memory, as the reference serves it, B=8,
        128 + 32;
    (e) one decode step of each arch (B=8, position 128) under
        ``torch.profiler``: host and kernel ms, the device's idle share,
        top-level aten ops and device kernels a layer.
    It prints its wall time.

12. The pod trainer (``launch/steps.make_train_step``, ``adamw(3e-3,
    warmup=10)``, ``remat="full"``), with every launch counter zeroed
    just before and read just after: none of #1-#8 may launch.
    (a) card against CPU, every assigned arch's reduced float32 config,
        one initialisation copied, B=2, S=64: the loss and every
        gradient leaf (``TRAIN_LOSS_ATOL``, ``TRAIN_GRAD_RTOL``), the
        three remat policies on the card against each other, then one
        train step each (loss, and every parameter within 2 lr);
    (b) phi3-mini-3.8b at its published widths, no depth cut, bf16
        parameters from a seeded card generator, B=4, S=1024: six steps
        on one batch of uniform tokens from a seeded card generator;
        every loss finite, the sixth below the first, every leaf changed
        but the bf16 norm scales still at their initial 1.0 (steps below
        half a bf16 ulp there); step ms (CUDA events, the median of
        steps 2-6) split into forward+backward and optimizer, tokens/s,
        ``6 * n_active_params * tokens`` a second, peak memory; a
        seventh step under ``torch.profiler`` for the device's idle
        share;
    (c) granite-moe-1b-a400m at its published widths, B=8, S=512, as
        (b), backward through the capacity dispatch, and the (token, k)
        assignments the first step's forward drops;
    (d) ``launch/train.main`` with ``--mode pod --arch qwen2-7b
        --reduced --steps 3`` on the card, whose checkpoint must load as
        the trained parameters bit for bit.
    It prints its wall time.
13. The compressed cross-pod gradient sync (``core/distributed.py``),
    one rank a pod, with each path's launch counters read:
    (a) a one-rank NCCL group (``FileStore``): reduced float32
        qwen2-7b, B=2, S=64, one ``make_train_step(grad_sync=
        "anycost")`` step at ``SYNC_KEEP`` on the card and on the CPU
        route (a one-rank gloo group beside it): the pod's loss and
        gradients at 12a's bounds, the synced values and the count of
        coordinates whose keep mask or int8 level differs (see
        ``SYNC_FLIP_SHARE``); #6 once a gradient leaf;
    (b) two ranks over gloo, spawned, both computing on ``cuda:0`` (the
        kernels built before the spawn): the reference's
        ``tests/test_distributed.py`` cases (exact, lossless, int8,
        sparse at 0.25, the zero collision near 4.0), a seeded Gaussian
        tree at ``SYNC_KEEP`` and two EF steps, each bit for bit
        against the plain sync in this process; ``mesh_cell_aggregate``
        with ``SYNC_CELLS`` rows at vgg9-cifar's N against the stacked
        Eq. 5, #7 once a row of the rank's block; a 4-cell, 8-device
        fmnist-cnn hierarchy (2 rounds) on ``agg_route="mesh"`` under
        cuDNN's deterministic algorithms against the streaming route
        here; both ranks' outputs bit for bit;
    (c) phi3-mini-3.8b as 12b with the ``"anycost"`` step at
        ``SYNC_KEEP`` in the one-rank NCCL group: step ms and tokens/s
        beside 12b's, the sync's share of a step (CUDA events around it),
        #6's launches a step, the peak memory, a falling loss.
    It prints its wall time.
14. Logical-axis sharding on DTensor (``sharding.py``, ``launch/steps``'s
    shardings), each path's launch counters read:
    (a) a one-rank NCCL group: reduced float32 qwen2-7b, one AdamW step
        under ``use_sharding(make_host_mesh())`` equals 12a's unsharded
        card step bit for bit (loss, gradients, parameters); none of
        #1-#8 launches;
    (b) two gloo ranks spawned on ``cuda:0`` (kernels built before the
        spawn): (a)'s step on (data=1, model=2) within 12a's bounds of the
        unsharded card step, every local shard on the card with its
        spec's share; the ``"anycost"`` step on (pod=2, data=1, model=1)
        bit for bit against the one-rank-a-pod step, #6 once a leaf, and
        each of its combines on the local shards bit for bit against
        ``aio_aggregate_ref`` on the same tensors; (a)'s step for reduced
        granite-moe-1b-a400m on (data=1, model=2), reduced qwen2-7b on
        (data=2, model=1) and reduced falcon-mamba-7b on both, each
        within 12a's bounds of the unsharded card step (``SHARD_B_CASES``);
    (c) phi3-mini-3.8b as 12b on the one-rank host mesh: losses equal to
        12b's bit for bit, step ms, tokens/s, peak;
    (d) the same on the two ranks of (b), (1, 2), full depth, three
        steps: per-rank peak, step ms, the first loss within
        ``SHARD_BF16_LOSS_ATOL`` of (c)'s;
    (e) ``python -m repro_torch.launch.dryrun`` for qwen2-7b train_4k on
        the single-pod mesh and phi3-mini-3.8b train_4k on the two-pod
        mesh with ``--grad-sync anycost``, side by side: rc 0 and the
        roofline terms printed;
    (f) ``tests/test_torch_dryrun.py``'s seven reduced pairs traced on
        ``meta`` tensors over a fake (pod=2, data=2, model=2) group under
        the card machine's torch, each in a subprocess: per-rank flops
        and collectives printed (granite-moe's ``"anycost"`` trace and
        falcon-mamba's train step included).
    It prints its wall time.
15. The port's examples (``examples/torch_*.py``) at their default sizes
    on the card: the eight FL and serving examples in this process
    (``runpy``), the launch counters reset before each and read after
    it, each example's report lines required; the quickstart's launches
    the reference's (#1/#2 and #5 once per feasible device, #6 once,
    nothing else); ``torch_multipod_dryrun.py`` in a subprocess of its
    own, started before 14e (its CPU traces beside 14e-14f and the
    other examples), rc 0, both meshes' ``[OK]`` lines echoed from the
    CLI and their roofline lines.  It prints
    each example's wall time and launches, and the phase's.
16. The last surface.  (a) The pytree helpers (``utils/pytree.py``) on
    the fmnist-cnn parameters as CUDA tensors, float32 and bf16 copies,
    against the same calls on the CPU: ``tree_dot`` rtol 1e-6 (products
    that do not cancel), the rest exact; (b) ``schedule.solve_population``
    on the 12-device population, equal to 12 ``solve`` calls; (c) a
    strided ``cnn.conv2d`` (stride 2, SAME and VALID, an odd and an even
    input) on the card against the CPU, rtol 1e-5; (d)
    ``scripts/validate_telemetry_torch.py --run`` in this process on the
    card, with every launch counter zeroed before and read after: the
    counts ``expected_launches`` derives for the hierarchical path (#7
    and #8 launched, #6 not).  It prints the phase's wall time.

The last lines are the card's name and power limit, one JSON object of
kernels, and the result line.  Without a card, or without the rest of
the repository beside this file, it exits non-zero and prints no result.
"""
from __future__ import annotations

import atexit
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
#: phase 10, LM serving.  10a: float32 reduced configs, card against
#: CPU, logits and caches at rtol and atol SERVE_CARD_CPU_TOL (read: at
#: most 5.1e-6).  The bf16 bounds at full width, each an absolute bound on
#: float32 logits, set from the first two card runs' readings on an H100:
#: 10b prefill against the decode loop PREFILL_DECODE_ATOL (read 0.0846
#: of logits up to 5.14, argmax all equal), 10c the sorted model against
#: the unsorted one SORTED_ATOL (read 0.1053, argmax agreement 0.945:
#: the permuted sums round in bf16 in another order), 10e a decode step
#: through ``gather`` against ``dispatch`` GATHER_ATOL (read 0.0).  10d
#: holds attention to the reference's 2e-5 (read 7.7e-7).
SERVE_CARD_CPU_TOL = 1e-4
PREFILL_DECODE_ATOL = 0.25
SORTED_ATOL = 0.3
GATHER_ATOL = 1e-2
ATTN_ATOL = 2e-5
#: phase 11, the recurrent and encoder-decoder LMs.  11a: float32 reduced
#: configs, card against CPU at SERVE_CARD_CPU_TOL, at the shapes of the
#: CPU tests: (arch, config overrides, prompt length), the SSM over two
#: scan chunks, the hybrid with a superblock, a two-layer tail and its
#: 64-slot attention ring wrapped.  The bf16 bounds at full width, each an
#: absolute bound on float32 logits: 11b forward_lm's last prompt position
#: against the decode-loop prefill SSM_LOOP_ATOL, 11c the same for the
#: hybrid HYBRID_LOOP_ATOL, 11d teacher-forced decode_encdec after
#: prefill_encdec_cache against forward_encdec ENCDEC_DECODE_ATOL; set
#: from the first card run's readings on an H100 (0.393 of logits up to
#: 4.62, argmax agreement 0.875: the forward's causal conv accumulates its
#: taps in bf16, the decode step's in float32, through 64 layers; 0.345,
#: agreement 0.75; 0.0685, agreement 1.0).
RECURRENT_CASES = (("falcon-mamba-7b", {}, 256),
                   ("recurrentgemma-9b", {"n_layers": 5}, 80),
                   ("seamless-m4t-large-v2", {}, 16))
SSM_LOOP_ATOL = 1.0
HYBRID_LOOP_ATOL = 1.0
ENCDEC_DECODE_ATOL = 0.25
#: phase 12, the pod trainer.  12a: float32 reduced configs, card against
#: CPU: the loss at TRAIN_LOSS_ATOL and each gradient leaf within
#: TRAIN_GRAD_RTOL of the leaf's largest |g| (phases 10a and 11a's bound);
#: after one AdamW step (warmup 10, so lr 3e-4 at step 1, and an update of
#: about lr * sign(g)) each parameter within 2 lr, the most a flipped
#: sign can move it; the three remat policies on the card against each
#: other bit for bit or, where an atomic add sums in another order,
#: within REMAT_GRAD_RTOL of the leaf's largest |g|.  12b and 12c train
#: at published widths on the pod trainer's recipe.
TRAIN_LOSS_ATOL = 1e-4
TRAIN_GRAD_RTOL = 1e-4
REMAT_GRAD_RTOL = 1e-5
POD_LR = 3e-3
POD_WARMUP = 10
POD_STEPS = 6
#: phase 13, the compressed cross-pod gradient sync.  13a, one pod in a
#: one-rank NCCL group, card against the CPU route (a one-rank gloo group
#: beside it): the loss and the local gradients at 12a's bounds; the
#: synced values within TRAIN_GRAD_RTOL of a leaf's largest |g| where the
#: card's and the CPU's keep mask and int8 level agree, and at most
#: SYNC_FLIP_SHARE of the coordinates where either differs (a level
#: flips where the gradients' 1e-6 noise crosses a rounding boundary,
#: about 1e-4 of the kept coordinates).  13b, two ranks over gloo on the
#: card: each sync case bit for bit against the plain computation in
#: this process, ``mesh_cell_aggregate`` within the reference's 1e-5,
#: the mesh-route hierarchy's losses at phase 3's rtol 1e-3 against the
#: streaming route.  13c trains at SYNC_KEEP, the reference's default,
#: and holds #6's output at the largest leaf's combine, (1, N) with N up
#: to 805,306,368, against aio_aggregate_ref on the same tensors bit for
#: bit.
SYNC_KEEP = 1.0 / 16.0
SYNC_FLIP_SHARE = 1e-3
SYNC_CELLS = 8


#: the subprocesses this script started, each leading a process group of
#: its own, which a failed check may leave running: ended at exit with
#: whatever they started
CHILDREN: list = []


def _end_children() -> None:
    import signal
    for proc in CHILDREN:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()


atexit.register(_end_children)


def clock() -> float:
    """The host's clock in seconds: every time this script prints is a
    measurement, none feeds a run."""
    # repro: ignore[unseeded-randomness] — timing is this script's output
    return time.perf_counter()


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
    t0 = clock()
    hist = run_fl(run_cfg, fleet, orch, device="cuda")
    torch.cuda.synchronize()
    wall = clock() - t0
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
            t0 = clock()
            try:
                return fn(*a, **k)
            finally:
                acc[key] = acc.get(key, 0.0) + clock() - t0
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
            t0 = clock()
            try:
                return fn(*a, **k)
            finally:
                acc.append(clock() - t0)
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
        t0 = clock()
        hist = run_fl(run_cfg, fleet, orch, device="cuda", telemetry=tel)
        torch.cuda.synchronize()
        return hist, ops.launch_counts(), clock() - t0

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


def serve_timed(model, params, B: int, S: int, n_dec: int,
                runs: int = 3) -> dict:
    """The serve entry point's ``generate`` on a seeded ``(B, S)`` prompt,
    ``runs`` times: the medians of the prefill ms and the decode ms a step
    (its clocks end in a synchronize), tok/s as the serve CLI counts it,
    and the last run's logits and tokens."""
    import statistics

    import numpy as np
    import torch
    from repro_torch.launch.serve import generate
    prompt = torch.tensor(np.random.default_rng(0).integers(
        0, model.cfg.vocab_size, (B, S)), dtype=torch.int32, device="cuda")
    pre, dec = [], []
    for _ in range(runs):
        r = generate(model, params, prompt, n_dec)
        pre.append(r["prefill_s"] * 1e3)
        dec.append(r["decode_s"] * 1e3 / (n_dec - 1))
    dec_ms = statistics.median(dec)
    return {"prefill_ms": statistics.median(pre), "decode_ms": dec_ms,
            "tok_s": B * 1e3 / dec_ms, "prefill_runs_ms": pre,
            "decode_runs_ms": dec, "logits": r["logits"],
            "tokens": r["tokens"]}


def serve_card_cpu(label: str, cfg, n_dec: int = 8) -> float:
    """Phase 10a: one float32 model initialised once on the CPU and
    copied to the card; prefill a 16-token prompt (B=2), then ``n_dec``
    decode steps teacher-forced with the CPU's greedy tokens, on both.
    The caches' ``k_pos`` exact, logits and caches at
    ``SERVE_CARD_CPU_TOL``.  Returns the largest logit difference."""
    import numpy as np
    import torch
    from repro_torch.models import transformer as T
    from repro_torch.models import vlm
    from repro_torch.models.registry import build_model
    from repro_torch.utils.pytree import tree_map
    model = build_model(cfg)
    cpu = model.init(torch.Generator().manual_seed(0), "cpu")
    card = tree_map(lambda t: t.to("cuda"), cpu)
    prompt = torch.tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 16)), dtype=torch.int32)
    err = 0.0

    def check(what, got, want):
        nonlocal err
        got = got.float().cpu()
        want = want.float()
        try:
            torch.testing.assert_close(got, want, rtol=SERVE_CARD_CPU_TOL,
                                       atol=SERVE_CARD_CPU_TOL)
        except AssertionError as e:
            fail(f"10a {label} {what}, card against CPU: {e}")
        err = max(err, float((got - want).abs().max()))

    extra = None
    if cfg.family == "vlm":
        patches = torch.tensor(np.random.default_rng(2).standard_normal(
            (2, cfg.vlm.n_patches, cfg.vlm.patch_embed_dim)),
            dtype=torch.float32)
        check("forward_vlm", vlm.forward_vlm(card, prompt.cuda(),
                                             patches.cuda(), cfg,
                                             remat="none"),
              vlm.forward_vlm(cpu, prompt, patches, cfg,
                                remat="none"))
        extra = patches
    cl, cc = T.prefill_lm(cpu, prompt, cfg, 16 + n_dec,
                          extra_embeds=None if extra is None else
                          vlm.project_patches(cpu, extra, 16, cfg))
    gl, gc = T.prefill_lm(card, prompt.cuda(), cfg, 16 + n_dec,
                          extra_embeds=None if extra is None else
                          vlm.project_patches(card, extra.cuda(), 16, cfg))
    check("prefill logits", gl, cl)
    for step in range(n_dec):
        tok = cl[:, -1:].argmax(-1).to(torch.int32)
        cl, cc = model.decode(cpu, cc, {"tokens": tok})
        gl, gc = model.decode(card, gc, {"tokens": tok.cuda()})
        check(f"decode step {step} logits", gl, cl)
    if not torch.equal(gc["blocks"]["k_pos"].cpu(), cc["blocks"]["k_pos"]):
        fail(f"10a {label}: the caches' k_pos differ")
    for k in ("k", "v"):
        check(f"cache {k}", gc["blocks"][k], cc["blocks"][k])
    print(f"[serve] 10a {label} (reduced, float32): prefill + {n_dec} "
          f"teacher-forced decode steps, card against CPU: k_pos exact, "
          f"largest logit difference {err!r}", flush=True)
    return err


@contextlib.contextmanager
def recording_routes(log: list):
    """Append the top-k expert indices of every MoE routing call over
    more than one token (the prefill's chunks) to ``log``."""
    from repro_torch.models import moe
    real = moe._route

    def route(router, x, cfg):
        out = real(router, x, cfg)
        if x.shape[1] > 1:
            log.append(out[1])
        return out

    moe._route = route
    try:
        yield
    finally:
        moe._route = real


def profiled(fn, ranges: dict) -> dict:
    """``fn()`` once under ``torch.profiler``, with each function in
    ``ranges`` (name -> (module, attribute)) wrapped in a
    ``record_function`` range of its name: the host ms of the call (it
    ends in a synchronize), the device ms of all its kernels (the
    device's own events) and of each range's kernels, the device's idle
    share of the host time, and the counts of the top-level aten ops and
    of the device's kernels.  A range inside which thousands of kernels
    run (the SSM scan) can come out with its kernels' time twice; time
    such a range with :func:`event_ms`."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    real = {name: (mod, getattr(mod, attr))
            for name, (mod, attr) in ranges.items()}

    def ranged(name, call):
        def wrapped(*a, **kw):
            with record_function(name):
                return call(*a, **kw)
        return wrapped

    for name, (mod, call) in real.items():
        setattr(mod, ranges[name][1], ranged(name, call))
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = clock()
            fn()
            torch.cuda.synchronize()
            host = (clock() - t0) * 1e3
    finally:
        for name, (mod, call) in real.items():
            setattr(mod, ranges[name][1], call)
    # the device's own events (kernels, memory copies and sets), without
    # the device-side annotations of the ranges' spans; a range's time is
    # the device time of the host ops inside it
    dev = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and e.key not in real]
    total = sum(e.self_device_time_total for e in dev) / 1e3
    got = dict.fromkeys(real, 0.0)
    got.update({e.key: e.device_time_total / 1e3 for e in prof.key_averages()
                if e.device_type == DeviceType.CPU and e.key in real})
    if total <= 0:
        fail(f"profiler: no device time recorded ({total} ms)")
    if total > host:
        fail(f"profiler: {total} ms of kernel time in {host} ms of host "
             f"time; kernels counted twice")
    # aten ops the host dispatched, not counting those another aten op
    # called, and the device's kernels (memory copies and sets included)
    aten = sum(1 for e in prof.events()
               if e.device_type == DeviceType.CPU
               and e.name.startswith("aten::")
               and not (e.cpu_parent is not None
                        and e.cpu_parent.name.startswith("aten::")))
    kernels = sum(e.count for e in dev)
    return {"host_ms": host, "device_ms": total,
            "idle_share": 1 - total / host, "aten_ops": aten,
            "device_kernels": kernels,
            **{f"{k}_ms": v for k, v in got.items()}}


def event_ms(fn, ranges: dict) -> dict:
    """``fn()`` once, with each function in ``ranges`` (name -> (module,
    attribute)) bracketed by CUDA events at every call: the device ms
    between each call's two events, summed per range, and between two
    events around the whole call (``"total"``).  On a device that is
    busy throughout (idle share near 0), that is the range's share of the
    kernel time."""
    import torch
    real = {name: (mod, getattr(mod, attr))
            for name, (mod, attr) in ranges.items()}
    marks = {name: [] for name in ranges}

    def bracketed(name, call):
        def wrapped(*a, **kw):
            pair = (torch.cuda.Event(enable_timing=True),
                    torch.cuda.Event(enable_timing=True))
            pair[0].record()
            result = call(*a, **kw)
            pair[1].record()
            marks[name].append(pair)
            return result
        return wrapped

    for name, (mod, call) in real.items():
        setattr(mod, ranges[name][1], bracketed(name, call))
    whole = (torch.cuda.Event(enable_timing=True),
             torch.cuda.Event(enable_timing=True))
    try:
        torch.cuda.synchronize()
        whole[0].record()
        fn()
        whole[1].record()
        torch.cuda.synchronize()
    finally:
        for name, (mod, call) in real.items():
            setattr(mod, ranges[name][1], call)
    out = {name: sum(a.elapsed_time(b) for a, b in pairs)
           for name, pairs in marks.items()}
    out["total"] = whole[0].elapsed_time(whole[1])
    return out


def free() -> None:
    """Collect garbage, return the card's cached blocks and restart its
    peak-memory count."""
    import gc

    import torch
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def build_full(arch: str, *, tag: str = "serve", **kw):
    """``arch``'s published config (fields replaced by ``kw``) and its
    parameters, drawn on the card from a seeded generator; prints their
    size and build time on a ``[tag]`` line."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model
    from repro_torch.utils.pytree import tree_leaves
    cfg = dataclasses.replace(get_config(arch), **kw)
    model = build_model(cfg)
    torch.cuda.synchronize()
    t0 = clock()
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        "cuda")
    torch.cuda.synchronize()
    gib = sum(t.numel() * t.element_size()
              for t in tree_leaves(params)) / 2**30
    print(f"[{tag}] {arch} full config ({cfg.n_layers} layers, d "
          f"{cfg.d_model}, {cfg.dtype}): {gib:.3f} GiB of parameters "
          f"({cfg.n_params()} by n_params) built on the card from a "
          f"seeded generator in {clock() - t0:.3f} s",
          flush=True)
    return model, params


def report_serve(label: str, r: dict, B: int, S: int, n_dec: int) -> dict:
    """Print one :func:`serve_timed` result with the peak memory since the
    last :func:`free`; fails on non-finite logits."""
    import torch
    peak = torch.cuda.max_memory_allocated() / 2**30
    if not bool(torch.isfinite(r["logits"]).all()):
        fail(f"{label}: non-finite logits")
    print(f"[serve] {label}: B={B}, prompt {S}, {n_dec} greedy tokens: "
          f"prefill {r['prefill_ms']:.3f} ms (runs "
          f"{[round(x, 3) for x in r['prefill_runs_ms']]}), decode "
          f"{r['decode_ms']:.3f} ms a step (runs "
          f"{[round(x, 3) for x in r['decode_runs_ms']]}), "
          f"{r['tok_s']:.1f} tok/s; peak memory {peak:.3f} GiB; sample "
          f"{r['tokens'][0, :8].tolist()}", flush=True)
    return {k: r[k] for k in ("prefill_ms", "decode_ms", "tok_s")} | {
        "peak_gib": peak}


def serving_phase() -> dict:
    """Phase 10: LM serving (see the module docstring).  Returns the
    numbers it printed."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import shrinking
    from repro_torch.device import resolve_device
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import prefill_into_cache, submodel
    from repro_torch.models import attention, moe, vlm
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    from repro_torch.models.registry import build_model
    from repro_torch.utils.pytree import tree_leaves, tree_map

    resolve_device("cuda")
    t_phase = clock()
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    out = {}

    # ---- 10a: card against CPU, float32, reduced configs
    for label, arch, kw in (("qwen2-7b", "qwen2-7b", {}),
                            ("qwen2-7b grouped heads", "qwen2-7b",
                             dict(n_heads=8, n_kv_heads=2, head_dim=32)),
                            ("granite-moe-1b-a400m", "granite-moe-1b-a400m",
                             {}),
                            ("pixtral-12b", "pixtral-12b", {})):
        cfg = dataclasses.replace(get_config(arch).reduced(), **kw)
        out[f"10a {label}"] = serve_card_cpu(label, cfg)

    # ---- 10b: qwen2-7b, full config
    free()
    model, params = build_full("qwen2-7b")
    cfg = model.cfg
    out["10b qwen2-7b"] = full = report_serve(
        "10b qwen2-7b", serve_timed(model, params, 8, 512, 64), 8, 512, 64)
    prompt = torch.tensor(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 64)), dtype=torch.int32, device="cuda")
    pre, _ = prefill_into_cache(model, params, prompt, 64)
    cache = model.init_cache(2, 64, "cuda")
    for t in range(64):
        loop, cache = model.decode(params, cache,
                                   {"tokens": prompt[:, t:t + 1]})
    err = float((pre[:, -1] - loop[:, 0]).abs().max())
    agree = float((pre[:, -1].argmax(-1) == loop[:, 0].argmax(-1))
                  .float().mean())
    scale = float(loop.abs().max())
    print(f"[serve] 10b qwen2-7b prefill (B=2, 64 tokens) against the "
          f"decode loop: last logits differ by up to {err!r} (largest "
          f"|logit| {scale!r}), argmax agreement {agree}; bound "
          f"{PREFILL_DECODE_ATOL}", flush=True)
    if not err <= PREFILL_DECODE_ATOL:
        fail(f"10b prefill against the decode loop: {err} > "
             f"{PREFILL_DECODE_ATOL}")
    del pre, loop, cache
    # where a prefill's and a decode step's time goes: one torch.profiler
    # run each, the float32 attention and the unembedding in ranges
    ranges = {"attention": (attention, "attention_dense"),
              "decode attention": (attention, "attention_decode"),
              "unembedding": (L, "head_logits")}
    prompt8 = torch.tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (8, 512)), dtype=torch.int32, device="cuda")
    holder = {}

    def prefill():
        holder["logits"], holder["cache"] = prefill_into_cache(
            model, params, prompt8, 512 + 4)

    def decode4():
        tok = holder["logits"][:, -1:].argmax(-1).to(torch.int32)
        for _ in range(4):
            logits, _ = model.decode(params, holder["cache"],
                                     {"tokens": tok})
            tok = logits[:, -1:].argmax(-1).to(torch.int32)

    for label, fn in (("prefill (B=8, 512)", prefill),
                      ("4 decode steps (B=8)", decode4)):
        prof = profiled(fn, ranges)
        out[f"10b profile {label}"] = prof
        shares = ", ".join(
            f"{k} {prof[k + '_ms']:.3f} ms "
            f"({prof[k + '_ms'] / prof['device_ms']:.4f})" for k in ranges)
        print(f"[serve] 10b qwen2-7b {label} under torch.profiler: "
              f"{prof['host_ms']:.3f} ms of host time, "
              f"{prof['device_ms']:.3f} ms of kernel time (device idle "
              f"{prof['idle_share']:.4f}); {shares}; "
              f"{prof['aten_ops']} top-level aten ops, "
              f"{prof['device_kernels']} device kernels "
              f"({cfg.n_layers} layers)", flush=True)
    del holder, prompt8

    # ---- 10c: the alpha 0.5 sub-model of 10b
    alpha = 0.5
    spec = shrinking.transformer_shrink_spec(cfg, params)
    sorted_p = shrinking.sort_channels(params, spec)
    a = T.forward_lm(params, prompt, cfg, remat="none")
    b = T.forward_lm(sorted_p, prompt, cfg, remat="none")
    err = float((a - b).abs().max())
    agree = float((a.argmax(-1) == b.argmax(-1)).float().mean())
    print(f"[serve] 10c sorted against unsorted qwen2-7b (B=2, 64 tokens): "
          f"logits differ by up to {err!r}, argmax agreement {agree}; bound "
          f"{SORTED_ATOL}", flush=True)
    if not err <= SORTED_ATOL:
        fail(f"10c sorted against unsorted: {err} > {SORTED_ATOL}")
    del a, b, sorted_p
    # the sub-model as the serve entry point cuts it, the full model
    # dropped before it serves; then with the mlp width rounded up to 128
    # lanes (the spec's round_to): 13396 bf16 columns are not a multiple
    # of 8, the 16-byte alignment cuBLAS's fastest tensor-core paths need
    for label, round_to in (("", 1), (" round_to=128", 128)):
        if params is None:
            model, params = build_full("qwen2-7b")
        scfg, sub, widths = submodel(cfg, params, alpha, round_to=round_to)
        if round_to == 1 and widths != {"mlp": 13396, "heads": 5}:
            fail(f"10c widths {widths}")
        if scfg.n_heads != 20:
            fail(f"10c sub-model n_heads {scfg.n_heads}")
        params = None
        free()
        gib = sum(t.untyped_storage().nbytes()
                  for t in tree_leaves(sub)) / 2**30
        smodel = build_model(scfg)
        out[f"10c qwen2-7b alpha 0.5{label}"] = half = report_serve(
            f"10c qwen2-7b alpha={alpha}{label} sub-model (widths: "
            f"{widths}, {gib:.3f} GiB held by its parameters)",
            serve_timed(smodel, sub, 8, 512, 64), 8, 512, 64)
        print(f"[serve] 10c full / alpha 0.5{label}: prefill "
              f"{full['prefill_ms']:.3f} / {half['prefill_ms']:.3f} ms, "
              f"decode {full['decode_ms']:.3f} / {half['decode_ms']:.3f} ms "
              f"a step", flush=True)
        del sub, smodel
    del model
    free()

    # ---- 10d: attention at qwen2-7b's head shapes, float32, B=1, S=4096
    gen = torch.Generator(device="cuda").manual_seed(4)
    S = 4096
    q = torch.randn((1, S, 28, 128), generator=gen, device="cuda")
    k = torch.randn((1, S, 4, 128), generator=gen, device="cuda")
    v = torch.randn((1, S, 4, 128), generator=gen, device="cuda")
    pos = torch.arange(S, device="cuda", dtype=torch.int32)
    for window in (None, 1024):
        want = attention.attention_dense(q, k, v, pos, pos, window=window)
        for skip in (False, True):
            got = attention.attend(q, k, v, pos, pos, window=window,
                                   causal_skip=skip)
            err = float((got - want).abs().max())
            ms = cuda_ms(lambda: attention.attend(
                q, k, v, pos, pos, window=window, causal_skip=skip),
                iters=2, runs=3, warmup=1)
            print(f"[serve] 10d attend S={S}, H 28 / KV 4 / hd 128, "
                  f"window {window}, causal_skip {skip}: blockwise against "
                  f"dense {err!r} (bound {ATTN_ATOL}); {ms:.3f} ms",
                  flush=True)
            if not err <= ATTN_ATOL:
                fail(f"10d blockwise window {window} skip {skip}: {err}")
        dense_ms = cuda_ms(lambda: attention.attention_dense(
            q, k, v, pos, pos, window=window), iters=2, runs=3, warmup=1)
        print(f"[serve] 10d attention_dense S={S}, window {window}: "
              f"{dense_ms:.3f} ms", flush=True)
    del q, k, v, want, got
    free()

    # ---- 10e: granite-moe-1b-a400m, full config
    model, params = build_full("granite-moe-1b-a400m")
    cfg = model.cfg
    routes = []
    with recording_routes(routes):
        r = serve_timed(model, params, 8, 512, 64, runs=1)
    cap = moe.capacity(cfg, 512)
    dropped = total = 0
    for idx in routes:
        onehot = torch.nn.functional.one_hot(idx, cfg.moe.n_experts).float()
        slots = moe.capacity_slots(onehot)
        dropped += int(((slots >= cap) * onehot).sum())
        total += idx.numel()
    print(f"[serve] 10e granite prefill (B=8, 512 tokens, one chunk, "
          f"capacity {cap} an expert): {dropped} of {total} (token, k) "
          f"assignments dropped ({dropped / total:.4f}) over "
          f"{len(routes)} routing calls", flush=True)
    out["10e granite"] = report_serve("10e granite-moe-1b-a400m",
                                serve_timed(model, params, 8, 512, 64),
                                8, 512, 64)
    out["10e granite"]["dropped"] = dropped
    prompt = torch.tensor(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (8, 512)), dtype=torch.int32, device="cuda")
    logits, cache = prefill_into_cache(model, params, prompt, 513)
    tok = logits[:, -1:].argmax(-1).to(torch.int32)
    step = {}
    for mode in ("dispatch", "gather"):
        mcfg = dataclasses.replace(cfg, moe_decode=mode)
        c = tree_map(lambda t: t.clone(), cache["blocks"])
        step[mode], _ = T.decode_lm(params, {"blocks": c, "pos": 512}, tok,
                                    mcfg)
    err = float((step["gather"] - step["dispatch"]).abs().max())
    agree = float((step["gather"].argmax(-1) == step["dispatch"].argmax(-1))
                  .float().mean())
    print(f"[serve] 10e granite decode step, gather against dispatch: "
          f"logits differ by up to {err!r}, argmax agreement {agree}; bound "
          f"{GATHER_ATOL}", flush=True)
    if not err <= GATHER_ATOL:
        fail(f"10e gather against dispatch: {err} > {GATHER_ATOL}")
    del model, params, logits, cache, step, c
    free()

    # ---- 10f: pixtral-12b, full config
    model, params = build_full("pixtral-12b")
    cfg = model.cfg
    patches = torch.randn((1, cfg.vlm.n_patches, cfg.vlm.patch_embed_dim),
                          generator=gen, device="cuda").to(cfg.param_dtype)
    toks = torch.tensor(np.random.default_rng(6).integers(
        0, cfg.vocab_size, (1, 2048)), dtype=torch.int32, device="cuda")
    torch.cuda.synchronize()
    t0 = clock()
    logits = vlm.forward_vlm(params, toks, patches, cfg, remat="none")
    torch.cuda.synchronize()
    ms = (clock() - t0) * 1e3
    if tuple(logits.shape) != (1, 2048, cfg.vocab_size) or not bool(
            torch.isfinite(logits).all()):
        fail(f"10f forward_vlm logits {tuple(logits.shape)}, finite "
             f"{bool(torch.isfinite(logits).all())}")
    print(f"[serve] 10f pixtral-12b forward_vlm B=1, {cfg.vlm.n_patches} "
          f"patches, S=2048: finite logits {tuple(logits.shape)} in "
          f"{ms:.3f} ms (first call)", flush=True)
    del logits
    out["10f pixtral"] = report_serve("10f pixtral-12b text",
                                serve_timed(model, params, 4, 256, 32),
                                4, 256, 32)
    del model, params, patches
    free()

    torch.cuda.synchronize()
    got = ops.launch_counts()
    if any(got.values()):
        fail(f"phase 10 launched kernels of the FL path: {json.dumps(got)}")
    wall = clock() - t_phase
    out["wall_s"] = wall
    print(f"[serve] phase 10: launches of #1-#8 {json.dumps(got)}; "
          f"{wall:.3f} s of wall time", flush=True)
    return out


def cache_leaves(tree, prefix: str = "") -> list:
    """(path, tensor) of every leaf of a decode cache (``pos`` aside) or
    of a parameter tree, in sorted-key order."""
    if isinstance(tree, dict):
        return [kv for k, v in sorted(tree.items()) if k != "pos"
                for kv in cache_leaves(v, f"{prefix}/{k}")]
    return [(prefix, tree)]


def recurrent_card_cpu(label: str, cfg, S: int, n_dec: int = 8) -> float:
    """Phase 11a: one float32 model initialised once on the CPU and copied
    to the card; the forward logits, the serve path's decode-loop prefill
    of an ``S``-token prompt (B=2), then ``n_dec`` decode steps
    teacher-forced with the CPU's greedy tokens, on both (encdec: also
    ``prefill_encdec_cache`` from frames).  Every cache's ``k_pos``
    exact, logits and every other cache leaf at ``SERVE_CARD_CPU_TOL``.
    Returns the largest difference."""
    import numpy as np
    import torch
    from repro_torch.launch.serve import prefill_into_cache
    from repro_torch.models import encdec
    from repro_torch.models.registry import build_model
    from repro_torch.utils.pytree import tree_map
    model = build_model(cfg)
    cpu = model.init(torch.Generator().manual_seed(0), "cpu")
    card = tree_map(lambda t: t.to("cuda"), cpu)
    prompt = torch.tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, S)), dtype=torch.int32)
    batch = {"tokens": prompt}
    if cfg.family == "encdec":
        batch["frames"] = torch.tensor(np.random.default_rng(2)
                                       .standard_normal((2, cfg.encdec
                                                         .n_frames,
                                                         cfg.d_model)),
                                       dtype=torch.float32)
    err = 0.0

    def check(what, got, want):
        nonlocal err
        got, want = got.cpu(), want.cpu()
        if what.endswith("k_pos"):
            if not torch.equal(got, want):
                fail(f"11a {label} {what}, card against CPU: differ")
            return
        try:
            torch.testing.assert_close(got.float(), want.float(),
                                       rtol=SERVE_CARD_CPU_TOL,
                                       atol=SERVE_CARD_CPU_TOL)
        except AssertionError as e:
            fail(f"11a {label} {what}, card against CPU: {e}")
        err = max(err, float((got.float() - want.float()).abs().max()))

    def check_cache(what, got, want):
        g, w = cache_leaves(got), cache_leaves(want)
        if [k for k, _ in g] != [k for k, _ in w] or got["pos"] != \
                want["pos"]:
            fail(f"11a {label} {what}: the caches' layouts differ")
        for (k, a), (_, b) in zip(g, w):
            check(f"{what} {k}", a, b)

    check("forward", model.forward(card, {k: v.cuda() for k, v in
                                          batch.items()}, remat="none"),
          model.forward(cpu, batch, remat="none"))
    if cfg.family == "encdec":
        check_cache("prefill_encdec_cache",
                    encdec.prefill_encdec_cache(card, batch["frames"].cuda(),
                                                cfg, 2, S + n_dec),
                    encdec.prefill_encdec_cache(cpu, batch["frames"], cfg,
                                                2, S + n_dec))
    cl, cc = prefill_into_cache(model, cpu, prompt, S + n_dec)
    gl, gc = prefill_into_cache(model, card, prompt.cuda(), S + n_dec)
    check("decode-loop prefill logits", gl, cl)
    for step in range(n_dec):
        tok = cl[:, -1:].argmax(-1).to(torch.int32)
        cl, cc = model.decode(cpu, cc, {"tokens": tok})
        gl, gc = model.decode(card, gc, {"tokens": tok.cuda()})
        check(f"decode step {step} logits", gl, cl)
    check_cache("decode cache", gc, cc)
    print(f"[recurrent] 11a {label} (reduced, float32, prompt {S}): "
          f"forward, decode-loop prefill + {n_dec} teacher-forced decode "
          f"steps and every cache leaf, card against CPU: k_pos exact, "
          f"largest difference {err!r}", flush=True)
    return err


def timed_ms(fn, runs: int = 3) -> tuple[float, list, object]:
    """``fn()`` ``runs`` times, each timed on the host's clock ending in a
    synchronize (the median drops the first call's allocations): (median
    ms, every run's ms, the last call's result)."""
    import statistics

    import torch
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = clock()
        result = fn()
        torch.cuda.synchronize()
        times.append((clock() - t0) * 1e3)
    return statistics.median(times), times, result


def print_profile(label: str, prof: dict, n_layers: int) -> None:
    print(f"[recurrent] {label} under torch.profiler: "
          f"{prof['host_ms']:.3f} ms of host time, {prof['device_ms']:.3f} "
          f"ms of kernel time (device idle {prof['idle_share']:.4f}); "
          f"{prof['aten_ops']} top-level aten ops and "
          f"{prof['device_kernels']} device kernels, "
          f"{prof['aten_ops'] / n_layers:.1f} and "
          f"{prof['device_kernels'] / n_layers:.1f} a layer ({n_layers} "
          f"layers)", flush=True)


def recurrent_lm(tag: str, model, params, ranges: dict, bound: float,
                 out: dict) -> None:
    """Phases 11b and 11c on one decoder LM at full width: ``forward_lm``
    at B=8, S=512 (ms, the median of 3; peak memory; one run under
    ``torch.profiler``; the shares of ``ranges`` from :func:`event_ms`);
    ``generate`` at B=8, a 128-token prompt through the decode-loop
    prefill and 32 greedy tokens; the last prompt
    position's logits from ``forward_lm`` against the decode loop's,
    within ``bound``; and one decode step from that prefilled cache under
    ``torch.profiler``."""
    import numpy as np
    import torch
    from repro_torch.launch.serve import prefill_into_cache
    from repro_torch.models import transformer as T
    cfg = model.cfg
    name = cfg.name
    prompt = torch.tensor(np.random.default_rng(7).integers(
        0, cfg.vocab_size, (8, 512)), dtype=torch.int32, device="cuda")
    free()
    ms, runs, logits = timed_ms(
        lambda: T.forward_lm(params, prompt, cfg, remat="none"))
    peak = torch.cuda.max_memory_allocated() / 2**30
    if not bool(torch.isfinite(logits).all()):
        fail(f"{tag} {name} forward_lm: non-finite logits")
    del logits
    print(f"[recurrent] {tag} {name} forward_lm B=8, S=512: {ms:.3f} ms "
          f"(runs {[round(x, 3) for x in runs]}); peak memory {peak:.3f} "
          f"GiB", flush=True)
    prof = profiled(
        lambda: T.forward_lm(params, prompt, cfg, remat="none"), {})
    print_profile(f"{tag} {name} forward_lm B=8, S=512", prof,
                  cfg.n_layers)
    ev = event_ms(
        lambda: T.forward_lm(params, prompt, cfg, remat="none"), ranges)
    print(f"[recurrent] {tag} {name} forward_lm B=8, S=512, CUDA events "
          f"around each call: {ev['total']:.3f} ms, "
          + ", ".join(f"{k} {ev[k]:.3f} ms ({ev[k] / ev['total']:.4f})"
                      for k in ranges), flush=True)
    out[f"{tag} {name} forward"] = {"ms": ms, "peak_gib": peak,
                                    "profile": prof, "events": ev}
    free()
    out[f"{tag} {name} serve"] = report_serve(
        f"{tag} {name}", serve_timed(model, params, 8, 128, 32, runs=1), 8,
        128, 32)
    # the forward's last prompt position against the decode loop's
    p128 = prompt[:, :128].contiguous()
    fwd = T.forward_lm(params, p128, cfg, remat="none")[:, -1]
    loop, cache = prefill_into_cache(model, params, p128, 129)
    loop = loop[:, 0]
    err = float((fwd - loop).abs().max())
    agree = float((fwd.argmax(-1) == loop.argmax(-1)).float().mean())
    print(f"[recurrent] {tag} {name} forward_lm against the decode-loop "
          f"prefill (B=8, 128 tokens), last position: logits differ by up "
          f"to {err!r} (largest |logit| {float(loop.abs().max())!r}), "
          f"argmax agreement {agree}; bound {bound}", flush=True)
    if not err <= bound:
        fail(f"{tag} {name} forward against the decode loop: {err} > "
             f"{bound}")
    out[f"{tag} {name} loop_err"] = err
    tok = loop.argmax(-1)[:, None].to(torch.int32)
    del fwd, loop
    prof = profiled(lambda: model.decode(params, cache, {"tokens": tok}),
                    {})
    print_profile(f"11e {name} one decode step (B=8, position 128)", prof,
                  cfg.n_layers)
    out[f"11e {name} decode step"] = prof
    del cache


def recurrent_phase() -> dict:
    """Phase 11: the recurrent and encoder-decoder LMs (see the module
    docstring).  Returns the numbers it printed."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.device import resolve_device
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import submodel
    from repro_torch.models import attention, encdec, ssm
    from repro_torch.models import layers as L
    from repro_torch.models.registry import build_model
    from repro_torch.utils.pytree import tree_leaves

    resolve_device("cuda")
    t_phase = clock()
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    out = {}

    # ---- 11a: card against CPU, float32, reduced configs
    for arch, kw, S in RECURRENT_CASES:
        cfg = dataclasses.replace(get_config(arch).reduced(), **kw)
        label = arch + "".join(f" {k}={v}" for k, v in kw.items())
        out[f"11a {label}"] = recurrent_card_cpu(label, cfg, S)

    # ---- 11b: falcon-mamba-7b, full config, and its alpha 0.5 sub-model
    free()
    model, params = build_full("falcon-mamba-7b")
    recurrent_lm("11b", model, params,
                 {"scan": (ssm, "_scan_chunk"),
                  "unembedding": (L, "head_logits")}, SSM_LOOP_ATOL, out)
    scfg, sub, widths = submodel(model.cfg, params, 0.5)
    del model, params
    free()
    gib = sum(t.untyped_storage().nbytes()
              for t in tree_leaves(sub)) / 2**30
    out["11b falcon-mamba-7b alpha 0.5"] = report_serve(
        f"11b falcon-mamba-7b alpha=0.5 sub-model (widths: {widths}, "
        f"{gib:.3f} GiB held by its parameters)",
        serve_timed(build_model(scfg), sub, 8, 128, 32, runs=1), 8, 128,
        32)
    del sub
    free()

    # ---- 11c: recurrentgemma-9b, full config
    model, params = build_full("recurrentgemma-9b")
    recurrent_lm("11c", model, params,
                 {"scan": (ssm, "_scan_chunk"),
                  "attention": (attention, "attention_dense"),
                  "unembedding": (L, "head_logits")},
                 HYBRID_LOOP_ATOL, out)
    del model, params
    free()

    # ---- 11d: seamless-m4t-large-v2, full config
    model, params = build_full("seamless-m4t-large-v2")
    cfg = model.cfg
    F = cfg.encdec.n_frames
    frames = torch.tensor(np.random.default_rng(8).standard_normal(
        (2, F, cfg.d_model)), dtype=cfg.param_dtype, device="cuda")
    free()
    ms, runs, _ = timed_ms(
        lambda: encdec.encode(params, frames, cfg, remat="none"))
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[recurrent] 11d seamless encode B=2, {F} frames (blockwise "
          f"attention above 2048): {ms:.3f} ms (runs "
          f"{[round(x, 3) for x in runs]}); peak memory {peak:.3f} GiB",
          flush=True)
    out["11d encode"] = {"ms": ms, "peak_gib": peak}
    toks = torch.tensor(np.random.default_rng(9).integers(
        0, cfg.vocab_size, (2, 256)), dtype=torch.int32, device="cuda")
    free()
    ms, runs, logits = timed_ms(lambda: encdec.forward_encdec(
        params, frames, toks, cfg, remat="none"))
    peak = torch.cuda.max_memory_allocated() / 2**30
    if tuple(logits.shape) != (2, 256, cfg.vocab_size) or not bool(
            torch.isfinite(logits).all()):
        fail(f"11d forward_encdec logits {tuple(logits.shape)}, finite "
             f"{bool(torch.isfinite(logits).all())}")
    print(f"[recurrent] 11d seamless forward_encdec B=2, {F} frames, S=256: "
          f"{ms:.3f} ms (runs {[round(x, 3) for x in runs]}); peak memory "
          f"{peak:.3f} GiB", flush=True)
    out["11d forward_encdec"] = {"ms": ms, "peak_gib": peak}
    # the cross-attention cache from the frames, then teacher-forced
    # decode against forward_encdec at every position
    S = 32
    fwd = encdec.forward_encdec(params, frames, toks[:, :S], cfg,
                                remat="none")
    cache = encdec.prefill_encdec_cache(params, frames, cfg, 2, S)
    err = 0.0
    agree = []
    for t in range(S):
        logits, cache = encdec.decode_encdec(params, cache,
                                             toks[:, t:t + 1], cfg)
        err = max(err, float((logits[:, 0] - fwd[:, t]).abs().max()))
        agree.append(logits[:, 0].argmax(-1) == fwd[:, t].argmax(-1))
    agree = float(torch.stack(agree).float().mean())
    print(f"[recurrent] 11d seamless prefill_encdec_cache + {S} "
          f"teacher-forced decode_encdec steps against forward_encdec "
          f"(B=2): logits differ by up to {err!r} (largest |logit| "
          f"{float(fwd.abs().max())!r}), argmax agreement {agree}; bound "
          f"{ENCDEC_DECODE_ATOL}", flush=True)
    if not err <= ENCDEC_DECODE_ATOL:
        fail(f"11d decode_encdec against forward_encdec: {err} > "
             f"{ENCDEC_DECODE_ATOL}")
    out["11d decode_err"] = err
    del fwd, cache, frames, logits
    free()
    out["11d seamless serve"] = report_serve(
        "11d seamless-m4t-large-v2 (zero encoder memory, as the reference "
        "serves it)", serve_timed(model, params, 8, 128, 32, runs=1), 8,
        128, 32)

    # ---- 11e: one decode step under torch.profiler (b and c above)
    cache = model.init_cache(8, 129, "cuda")
    cache["pos"] = 128
    tok = toks[:, :1].repeat(4, 1)
    prof = profiled(lambda: model.decode(params, cache, {"tokens": tok}),
                    {})
    print_profile("11e seamless-m4t-large-v2 one decode step (B=8, position "
                  "128)", prof, cfg.encdec.n_dec_layers)
    out["11e seamless decode step"] = prof
    del model, params, cache
    free()

    torch.cuda.synchronize()
    got = ops.launch_counts()
    if any(got.values()):
        fail(f"phase 11 launched kernels of the FL path: {json.dumps(got)}")
    wall = clock() - t_phase
    out["wall_s"] = wall
    print(f"[recurrent] phase 11: launches of #1-#8 {json.dumps(got)}; "
          f"{wall:.3f} s of wall time", flush=True)
    return out


def train_card_cpu(arch: str) -> dict:
    """Phase 12a on one reduced float32 arch: one initialisation on the
    CPU copied to the card, one batch (B=2, S=64 tokens from a seeded
    numpy generator, the launcher's modality extras); the loss and
    gradients card against CPU, the remat policies against each other on
    the card, then one train step on each.  Returns the differences."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_train_step, value_and_grad
    from repro_torch.launch.train import _modality_extras
    from repro_torch.models.registry import build_model
    from repro_torch.train.optimizer import adamw
    from repro_torch.utils.pytree import tree_leaves, tree_map
    cfg = get_config(arch).reduced()
    model = build_model(cfg)
    cpu = model.init(torch.Generator().manual_seed(0), "cpu")
    card = tree_map(lambda t: t.to("cuda"), cpu)
    batch = {"tokens": torch.tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 64)), dtype=torch.int32)}
    batch.update(_modality_extras(cfg, 2, 64, "cpu"))
    gbatch = {k: v.cuda() for k, v in batch.items()}
    want_loss, want = value_and_grad(model, cpu, batch, remat="full")
    got = {r: value_and_grad(model, card, gbatch, remat=r)
           for r in ("full", "dots", "none")}

    def worst(a, b):
        """The largest leaf difference over the leaf's largest |g|."""
        out = 0.0
        for x, y in zip(tree_leaves(a), tree_leaves(b)):
            x, y = x.float().cpu(), y.float().cpu()
            scale = float(y.abs().max())
            err = float((x - y).abs().max())
            out = max(out, err / scale if scale > 0 else err)
        return out

    loss_err = abs(float(got["full"][0]) - float(want_loss))
    grad_err = worst(got["full"][1], want)
    if not (loss_err <= TRAIN_LOSS_ATOL and grad_err <= TRAIN_GRAD_RTOL):
        fail(f"12a {arch}: card against CPU, loss {loss_err} (bound "
             f"{TRAIN_LOSS_ATOL}), gradients {grad_err} of a leaf's "
             f"largest |g| (bound {TRAIN_GRAD_RTOL})")
    remat = {}
    for r in ("dots", "none"):
        same = torch.equal(got[r][0], got["full"][0]) and all(
            torch.equal(x, y) for x, y in zip(tree_leaves(got[r][1]),
                                              tree_leaves(got["full"][1])))
        remat[r] = 0.0 if same else max(
            worst(got[r][1], got["full"][1]),
            abs(float(got[r][0]) - float(got["full"][0])))
        if not remat[r] <= REMAT_GRAD_RTOL:
            fail(f"12a {arch}: remat {r} against full on the card: "
                 f"{remat[r]} > {REMAT_GRAD_RTOL}")
    del got
    opt = adamw(POD_LR, warmup=POD_WARMUP)
    step = make_train_step(model, opt, remat="full")
    cpu, _, cl = step(cpu, opt.init(cpu), batch)
    card, _, gl = step(card, opt.init(card), gbatch)
    step_loss = abs(float(gl) - float(cl))
    lr1 = POD_LR * min(1.0, 1 / POD_WARMUP)
    moved = max(float((x.float().cpu() - y.float()).abs().max())
                for x, y in zip(tree_leaves(card), tree_leaves(cpu)))
    if not (step_loss <= TRAIN_LOSS_ATOL and moved <= 2 * lr1 * 1.001):
        fail(f"12a {arch}: train step card against CPU, loss {step_loss} "
             f"(bound {TRAIN_LOSS_ATOL}), parameters {moved} (bound "
             f"{2 * lr1})")
    print(f"[pod] 12a {arch} ({cfg.family}, reduced, float32), card "
          f"against CPU: loss {loss_err!r}, gradients {grad_err!r} of a "
          f"leaf's largest |g|; remat dots / none against full on the "
          f"card {remat['dots']!r} / {remat['none']!r} (0.0: bit for "
          f"bit); after one AdamW step, loss {step_loss!r}, parameters "
          f"{moved!r} (2 lr = {2 * lr1!r})", flush=True)
    return {"loss": loss_err, "grads": grad_err, "remat": remat,
            "step_loss": step_loss, "params": moved}


def train_full(label: str, arch: str, B: int, S: int, mesh=None) -> dict:
    """Phases 12b, 12c and 13c: ``POD_STEPS`` pod-trainer steps of
    ``arch`` at its published widths on one batch of seeded uniform
    tokens, timed with CUDA events, then a step under ``torch.profiler``.
    With a ``mesh``, the ``"anycost"`` step at ``SYNC_KEEP`` over its
    "pod" group: the launches of #6 a step, one more step with CUDA
    events around the sync for its share, and, after the profiled step,
    one whose largest combine is held against the plain version
    (:func:`largest_combine`).  Fails on a non-finite loss, a
    loss that does not fall or a leaf that did not move (see the module
    docstring).  Returns the numbers it printed."""
    import statistics

    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import steps
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import moe
    from repro_torch.train.optimizer import Optimizer, adamw
    from repro_torch.utils.pytree import tree_leaves
    free()
    model, params = build_full(arch, tag="pod")
    cfg = model.cfg
    gen = torch.Generator(device="cuda").manual_seed(12)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S),
                                     generator=gen, device="cuda",
                                     dtype=torch.int32)}
    out = {}
    if cfg.family == "moe":     # the drops of the first step's forward
        routes = []
        with torch.no_grad(), recording_routes(routes):
            model.forward(params, batch, remat="none")
        cap = moe.capacity(cfg, min(moe.MOE_CHUNK, S))
        dropped = total = 0
        for idx in routes:
            onehot = torch.nn.functional.one_hot(
                idx, cfg.moe.n_experts).float()
            dropped += int(((moe.capacity_slots(onehot) >= cap)
                            * onehot).sum())
            total += idx.numel()
        out["dropped"] = dropped
        print(f"[pod] {label} {arch} first step's forward (B={B}, S={S}, "
              f"capacity {cap} an expert a chunk): {dropped} of {total} "
              f"(token, k) assignments dropped ({dropped / total:.4f})",
              flush=True)
        del routes
    opt = adamw(POD_LR, warmup=POD_WARMUP)
    marks, fb_peaks = [], []

    def update(p, g, s):
        # an event where the optimizer starts, and the allocator's peak
        # so far (host-side accounting, no synchronize)
        marks.append(torch.cuda.Event(enable_timing=True))
        marks[-1].record()
        fb_peaks.append(torch.cuda.max_memory_allocated())
        return opt.update(p, g, s)

    state = opt.init(params)
    sync = {} if mesh is None else dict(grad_sync="anycost",
                                        keep_frac=SYNC_KEEP, mesh=mesh)
    step = make_train_step(model, Optimizer(opt.init, update),
                           remat="full", **sync)
    paths = [p for p, _ in cache_leaves(params)]
    before = [t.to("cpu", copy=True) for t in tree_leaves(params)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    launches0 = ops.launch_counts()
    t0 = clock()
    starts, ends, losses = [], [], []
    for _ in range(POD_STEPS):
        starts.append(torch.cuda.Event(enable_timing=True))
        ends.append(torch.cuda.Event(enable_timing=True))
        starts[-1].record()
        params, state, loss = step(params, state, batch)
        ends[-1].record()
        losses.append(loss)
    torch.cuda.synchronize()
    wall = clock() - t0
    out["launches"] = {k: v - launches0[k]
                       for k, v in ops.launch_counts().items()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    step_ms = [a.elapsed_time(b) for a, b in zip(starts, ends)]
    fb_ms = [a.elapsed_time(m) for a, m in zip(starts, marks)]
    opt_ms = [m.elapsed_time(b) for m, b in zip(marks, ends)]
    losses = [float(x) for x in torch.stack(losses).cpu()]
    if not all(math.isfinite(x) for x in losses):
        fail(f"{label} {arch}: non-finite loss {losses}")
    if not losses[-1] < losses[0]:
        fail(f"{label} {arch}: the loss did not fall on its batch: "
             f"{losses}")
    # every leaf moved, but a bf16 leaf of ones (a norm scale): there a
    # step below half a bf16 ulp (2^-9 below 1.0) rounds back to 1.0, and
    # the schedule stays below it for the first steps
    m_leaves = tree_leaves(state["m"])
    still = []
    for path, a, b, m in zip(paths, tree_leaves(params), before, m_leaves):
        if torch.equal(a.cpu(), b):
            if not (a.dtype == torch.bfloat16 and bool((b == 1).all())
                    and bool((m != 0).any())):
                fail(f"{label} {arch}: leaf {path} did not move")
            still.append(path)
    del before
    ms = statistics.median(step_ms[1:])
    tokens = B * S
    flops = 6 * cfg.n_active_params() * tokens
    out.update({"step_ms": ms, "fb_ms": statistics.median(fb_ms[1:]),
                "opt_ms": statistics.median(opt_ms[1:]),
                "tok_s": tokens * 1e3 / ms,
                "tflop_s": flops / (ms / 1e3) / 1e12, "peak_gib": peak,
                "fb_peak_gib": fb_peaks[0] / 2**30, "losses": losses})
    print(f"[pod] {label} {arch} B={B}, S={S}, remat full, adamw("
          f"{POD_LR}, warmup={POD_WARMUP}), {POD_STEPS} steps in "
          f"{wall:.3f} s: losses {[round(x, 4) for x in losses]}; step "
          f"{ms:.3f} ms (median of steps 2-{POD_STEPS}; all "
          f"{[round(x, 3) for x in step_ms]}), forward+backward "
          f"{out['fb_ms']:.3f} ms and optimizer {out['opt_ms']:.3f} ms "
          f"(steps: {[round(x, 3) for x in fb_ms]} / "
          f"{[round(x, 3) for x in opt_ms]}); {out['tok_s']:.1f} tokens/s, "
          f"6 * n_active_params * tokens {flops:.4e} FLOP = "
          f"{out['tflop_s']:.3f} TFLOP/s; peak memory {peak:.3f} GiB "
          f"({out['fb_peak_gib']:.3f} GiB before the first optimizer "
          f"update); "
          f"{len(paths) - len(still)} of {len(paths)} leaves moved, "
          f"unmoved bf16 ones {still}", flush=True)
    if mesh is not None:
        out["sync_launches"] = out["launches"]["aio_aggregate"] / POD_STEPS
        ev = event_ms(lambda: step(params, state, batch),
                      {"sync": (steps, "anycost_gradient_sync")})
        out["sync_ms"], out["sync_share"] = ev["sync"], ev["sync"] / ev[
            "total"]
        print(f"[sync] {label} {arch} anycost sync at keep_frac "
              f"{SYNC_KEEP}: {ev['sync']:.3f} ms of a {ev['total']:.3f} ms "
              f"step (CUDA events, step {POD_STEPS + 1}), share "
              f"{out['sync_share']:.4f}; #6 launches a step "
              f"{out['sync_launches']:.1f} (one per gradient leaf, "
              f"{len(paths)}); launches over the {POD_STEPS} steps "
              f"{json.dumps(out['launches'])}", flush=True)
    prof = profiled(lambda: step(params, state, batch), {})
    out["profile"] = prof
    print(f"[pod] {label} {arch} step {POD_STEPS + 1} under torch.profiler: "
          f"{prof['host_ms']:.3f} ms of host time, {prof['device_ms']:.3f} "
          f"ms of kernel time (device idle {prof['idle_share']:.4f}); "
          f"{prof['aten_ops']} top-level aten ops, {prof['device_kernels']} "
          f"device kernels", flush=True)
    if mesh is not None:
        out["largest_combine"] = largest_combine(
            lambda: step(params, state, batch),
            max(p.numel() for p in tree_leaves(params)), f"{label} {arch}")
    del model, params, state, step, batch, m_leaves
    free()
    return out


def largest_combine(run, n_max: int, label: str) -> dict:
    """One more ``"anycost"`` step, ``run()``, with #6's wrapper watched:
    the combine of the first leaf of ``n_max`` elements (the largest)
    keeps its gathered values, mask, weights and output, and after the
    step the output must equal ``aio_aggregate_ref`` on those same
    tensors bit for bit (in column chunks: Eq. 5 is elementwise over
    ``N``, so chunking changes no bit).  Fails otherwise; returns the
    shape and the max abs error."""
    import torch
    from repro_torch.kernels import ops, ref
    seen = {}
    real = ops.aio_aggregate_op

    def watched(u, m, w):
        out = real(u, m, w)
        if not seen and u.shape[-1] == n_max:
            seen.update(u=u, m=m, w=w, out=out)
        return out

    ops.aio_aggregate_op = watched
    try:
        run()
    finally:
        ops.aio_aggregate_op = real
    torch.cuda.synchronize()
    if not seen:
        fail(f"{label}: no #6 combine at the largest leaf's N = {n_max}")
    u, m, w, got = seen["u"], seen["m"], seen["w"], seen["out"]
    err, differ, chunk = 0.0, 0, 1 << 27
    for a in range(0, n_max, chunk):
        b = min(a + chunk, n_max)
        want = ref.aio_aggregate_ref(u[:, a:b], m[:, a:b], w)
        differ += int((got[a:b] != want).sum())
        err = max(err, float((got[a:b] - want).abs().max()))
        del want
    kept = int((m != 0).sum())
    res = {"shape": list(u.shape), "max_abs_err": err, "differ": differ,
           "kept": kept}
    print(f"[sync] {label}: #6 at the largest leaf's combine, (I, N) = "
          f"{tuple(u.shape)}, {kept} coordinates kept, against "
          f"aio_aggregate_ref on the same tensors: {differ} elements "
          f"differ, max abs err {err}", flush=True)
    if differ or kept == 0:
        fail(f"{label}: #6 at {tuple(u.shape)} is not aio_aggregate_ref "
             f"bit for bit ({differ} elements differ) or kept nothing")
    del seen, u, m, w, got
    return res


def pod_phase() -> dict:
    """Phase 12: the pod trainer (see the module docstring).  Returns the
    numbers it printed."""
    import tempfile

    import torch
    from repro_torch.configs import ASSIGNED_ARCHS
    from repro_torch.device import resolve_device
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launch_train
    from repro_torch.train.checkpoint import load_checkpoint
    from repro_torch.utils.pytree import tree_leaves

    resolve_device("cuda")
    t_phase = clock()
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    out = {}
    # ---- 12a: card against CPU, float32, reduced configs
    for arch in ASSIGNED_ARCHS:
        out[f"12a {arch}"] = train_card_cpu(arch)
    # ---- 12b, 12c: published widths
    out["12b"] = train_full("12b", "phi3-mini-3.8b", 4, 1024)
    out["12c"] = train_full("12c", "granite-moe-1b-a400m", 8, 512)
    # ---- 12d: the launcher's --mode pod on the card
    with tempfile.TemporaryDirectory() as d:
        losses, params = launch_train.main([
            "--mode", "pod", "--arch", "qwen2-7b", "--reduced", "--steps",
            "3", "--batch", "2", "--seq-len", "64", "--checkpoint", d])
        loaded, step, _ = load_checkpoint(d)
    got, want = tree_leaves(loaded), tree_leaves(params)
    if step != 3 or len(got) != len(want) or not all(
            a.dtype == b.dtype and torch.equal(a, b.cpu())
            for a, b in zip(got, want)):
        fail("12d: the checkpoint does not load as the trained parameters")
    if want[0].device.type != "cuda":
        fail("12d: the launcher did not train on the card")
    print(f"[pod] 12d launch.train --mode pod --arch qwen2-7b --reduced on "
          f"the card: losses {losses}; the checkpoint loads as the "
          f"trained parameters bit for bit ({len(got)} leaves)", flush=True)
    del loaded, params
    free()

    torch.cuda.synchronize()
    got = ops.launch_counts()
    if any(got.values()):
        fail(f"phase 12 launched kernels of the FL path: {json.dumps(got)}")
    wall = clock() - t_phase
    out["wall_s"] = wall
    print(f"[pod] phase 12: launches of #1-#8 {json.dumps(got)}; "
          f"{wall:.3f} s of wall time", flush=True)
    return out


class PodGroup:
    """A stand-in for a ``DeviceMesh`` whose "pod" dimension is a given
    process group (the CPU route's one-rank gloo group beside NCCL)."""

    def __init__(self, group):
        self.group = group

    def get_group(self, name: str):
        return self.group


def plain_sync(pods: list, keep_frac: float, quantize: bool) -> tuple:
    """The compressed sync of one leaf over the pods' values ``pods``, in
    this process: each pod's local compression, then the plain Eq. 5
    (``aio_aggregate_ref``) over the stacked dequantized values and masks
    with unit weights.  Returns ``(synced, [what each pod sent])``."""
    import torch
    from repro_torch.core import distributed
    from repro_torch.kernels import ref
    vals, masks, sent = [], [], []
    for g in pods:
        keep, payload, scale = distributed._local_compress(g, keep_frac,
                                                           quantize)
        v = payload.float() * scale if quantize else payload
        vals.append(v.reshape(-1))
        sent.append(v)
        masks.append(torch.ones_like(v.reshape(-1)) if keep_frac >= 1.0
                     else keep.float().reshape(-1))
    out = ref.aio_aggregate_ref(torch.stack(vals), torch.stack(masks),
                                torch.ones(len(pods), device=vals[0].device))
    return out.view(pods[0].shape).to(pods[0].dtype), sent


#: 13b's sync cases: name -> (inputs, keep_frac, quantize); inputs are
#: the reference's tests/test_distributed.py leaves, its zero-collision
#: leaf, and a seeded Gaussian tree
SYNC_CASES = {"lossless": ("script", 1.0, False),
              "int8": ("script", 1.0, True),
              "sparse": ("script", 0.25, False),
              "collision": ("collide", 0.999999, True),
              "default": ("gauss", SYNC_KEEP, True)}


def sync_inputs() -> dict:
    """13b's stacked (pod-leading) input trees, float32 on the CPU."""
    import torch
    gen = torch.Generator().manual_seed(13)
    return {
        "script": {"w": (torch.arange(64.0).view(2, 32) + 1.0) / 64.0,
                   "b": torch.tensor([[1.0, -2.0], [3.0, -4.0]])},
        "collide": {"w": torch.tensor([[100.0, 0.05, 50.0, -25.0],
                                       [100.0, 8.0, 50.0, -25.0]])},
        "gauss": {"a": torch.randn(2, 4096, generator=gen),
                  "b": torch.randn(2, 96, 128, generator=gen)}}


def cell_inputs(n: int) -> tuple:
    """13b's ``(SYNC_CELLS, n)`` updates, masks and weights (CPU)."""
    import torch
    gen = torch.Generator().manual_seed(14)
    u = torch.randn(SYNC_CELLS, n, generator=gen)
    m = (torch.rand(SYNC_CELLS, n, generator=gen) > 0.4).float()
    w = torch.rand(SYNC_CELLS, generator=gen) + 0.5
    return u, m, w


def hier_configs():
    """13b's hierarchy: fmnist-cnn, 8 devices in 4 cells, 2 rounds."""
    from repro_torch.sysmodel.population import FleetConfig
    from repro_torch.topology import TopologyConfig
    from repro_torch.train.fl_loop import FLRunConfig
    return (FLRunConfig(rounds=2, n_train=512, n_test=128, eval_every=1,
                        seed=5, use_planner=False),
            FleetConfig(n_devices=8,
                        topology=TopologyConfig(kind="hier", n_cells=4)))


def hier_run(route: str) -> tuple:
    """13b's hierarchy on ``route`` on the card, under cuDNN's
    deterministic algorithms (the ranks must compute the same updates):
    ``(round logs, launches)``."""
    from repro_torch.kernels import ops
    from repro_torch.orchestrator.policies import OrchestratorConfig
    from repro_torch.train.fl_loop import run_fl
    run_cfg, fleet = hier_configs()
    ops.reset_launch_counts()
    with deterministic_cudnn():
        hist = run_fl(run_cfg, fleet, OrchestratorConfig(agg_route=route),
                      device="cuda")
    rounds = [(r.test_loss, r.n_clients, r.n_cells_reporting,
               r.backhaul_bits) for r in hist.rounds]
    return rounds, ops.launch_counts()


def pod_rank(rank: int, store: str, out_dir: str, n_cells: int) -> None:
    """One of 13b's two ranks: a gloo group over a ``FileStore``, every
    tensor on ``cuda:0``; what it computed goes to
    ``out_dir/rank{rank}.pt``."""
    import torch
    import torch.distributed as dist
    from repro_torch.core import distributed
    from repro_torch.device import resolve_device
    from repro_torch.kernels import ops
    resolve_device("cuda")
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(store, 2),
                            rank=rank, world_size=2)
    out = {"sync": {}}
    inputs = sync_inputs()

    def pod(tree):
        return {k: v[rank].cuda() for k, v in tree.items()}

    def host(tree):
        return {k: v.cpu() for k, v in tree.items()}

    ops.reset_launch_counts()
    for name, (inp, keep, quant) in SYNC_CASES.items():
        out["sync"][name] = host(distributed.anycost_gradient_sync(
            pod(inputs[inp]), "pod", keep_frac=keep, quantize=quant))
    out["exact"] = host(distributed.mean_gradient_sync(
        pod(inputs["gauss"])))
    g = pod(inputs["gauss"])
    res = distributed.init_error_feedback(g)
    out["ef"] = []
    for _ in range(2):
        synced, res = distributed.anycost_gradient_sync_ef(
            g, res, keep_frac=0.25)
        out["ef"].append((host(synced), host(res)))
    torch.cuda.synchronize()
    out["sync_launches"] = ops.launch_counts()
    u, m, w = (t.cuda() for t in cell_inputs(n_cells))
    ops.reset_launch_counts()
    out["cells"] = distributed.mesh_cell_aggregate(u, m, w).cpu()
    torch.cuda.synchronize()
    out["cell_launches"] = ops.launch_counts()
    out["hier"] = hier_run("mesh")
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()


def sync_card_cpu() -> dict:
    """Phase 13a (see the module docstring): one pod on the card, in the
    one-rank NCCL group, against the CPU route.  Returns the numbers it
    printed and the card step's launches."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.core import distributed
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as pmesh
    from repro_torch.launch.steps import make_train_step, value_and_grad
    from repro_torch.models.registry import build_model
    from repro_torch.train.optimizer import Optimizer, sgd
    from repro_torch.utils.pytree import tree_leaves, tree_map
    cpu_pod = PodGroup(dist.new_group([0], backend="gloo"))
    card_pod = pmesh.make_pod_mesh(1)
    cfg = get_config("qwen2-7b").reduced()
    model = build_model(cfg)
    cpu = model.init(torch.Generator().manual_seed(0), "cpu")
    card = tree_map(lambda t: t.to("cuda", copy=True), cpu)
    batch = {"tokens": torch.tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 64)), dtype=torch.int32)}
    gbatch = {k: v.cuda() for k, v in batch.items()}
    # the pod's own loss and gradients, before the sync
    want_loss, want = value_and_grad(model, cpu, batch, remat="full")
    got_loss, got = value_and_grad(model, card, gbatch, remat="full")
    loss_err = abs(float(got_loss) - float(want_loss))
    grad_err = max(float((x.cpu() - y).abs().max()) / float(y.abs().max())
                   for x, y in zip(tree_leaves(got), tree_leaves(want)))
    if not (loss_err <= TRAIN_LOSS_ATOL and grad_err <= TRAIN_GRAD_RTOL):
        fail(f"13a: card against CPU before the sync, loss {loss_err}, "
             f"gradients {grad_err}")
    synced = {}

    def recording(where):
        opt = sgd(POD_LR)

        def update(p, g, s):
            synced[where] = [x.float().cpu() for x in tree_leaves(g)]
            return opt.update(p, g, s)

        return Optimizer(opt.init, update)

    launched = {}
    for where, params, b, mesh in (("cpu", cpu, batch, cpu_pod),
                                   ("card", card, gbatch, card_pod)):
        step = make_train_step(model, recording(where), remat="full",
                               grad_sync="anycost", keep_frac=SYNC_KEEP,
                               mesh=mesh)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        _, _, loss = step(params, sgd(POD_LR).init(params), b)
        torch.cuda.synchronize()
        launched[where] = ops.launch_counts()
        synced[where + "_loss"] = float(loss)
    step_loss = abs(synced["card_loss"] - synced["cpu_loss"])
    n_leaves = len(tree_leaves(cpu))
    if launched["card"]["aio_aggregate"] != n_leaves:
        fail(f"13a: #6 launched {launched['card']['aio_aggregate']} times "
             f"in the card's step, expected one a leaf ({n_leaves})")
    if any(launched["cpu"].values()):
        fail(f"13a: the CPU route launched kernels: {launched['cpu']}")
    # where the card's and the CPU's keep mask and int8 level differ
    differ = total = 0
    worst = 0.0
    for gc, gg, sc, sg in zip(tree_leaves(want), tree_leaves(got),
                              synced["cpu"], synced["card"]):
        kc, qc, _ = distributed._local_compress(gc, SYNC_KEEP, True)
        kg, qg, _ = distributed._local_compress(gg, SYNC_KEEP, True)
        moved = (kc != kg.cpu()) | (qc != qg.cpu())
        differ += int(moved.sum())
        total += moved.numel()
        same = ~moved.reshape(-1)
        scale = float(sc.abs().max())
        if same.any() and scale > 0:
            worst = max(worst, float((sg.reshape(-1)[same]
                                      - sc.reshape(-1)[same]).abs().max())
                        / scale)
    if not (step_loss <= TRAIN_LOSS_ATOL and worst <= TRAIN_GRAD_RTOL
            and differ <= SYNC_FLIP_SHARE * total):
        fail(f"13a: the anycost step, card against CPU: loss {step_loss}, "
             f"synced values {worst} of a leaf's largest |g| (bound "
             f"{TRAIN_GRAD_RTOL}), {differ} of {total} coordinates with "
             f"another keep mask or level (bound {SYNC_FLIP_SHARE})")
    print(f"[sync] 13a qwen2-7b reduced float32, one pod (NCCL group of "
          f"1), keep_frac {SYNC_KEEP}, card against CPU: pod loss "
          f"{loss_err!r}, pod gradients {grad_err!r} of a leaf's largest "
          f"|g|; after the sync, step loss {step_loss!r}, synced values "
          f"{worst!r} where mask and level agree; {differ} of {total} "
          f"coordinates with another keep mask or int8 level; #6 launched "
          f"{launched['card']['aio_aggregate']} times (one a leaf)",
          flush=True)
    return {"loss": loss_err, "grads": grad_err, "step_loss": step_loss,
            "synced": worst, "differ": differ, "total": total,
            "launches": launched["card"]}


def two_pods_on_one_card() -> dict:
    """Phase 13b (see the module docstring): spawns :func:`pod_rank`
    twice and holds what they computed against the plain computation in
    this process.  Returns the ranks' launches by path."""
    import tempfile

    import torch
    import torch.multiprocessing as mp
    from repro_torch.configs import get_config
    from repro_torch.kernels import ref
    from repro_torch.models.registry import build_model
    from repro_torch.utils.pytree import tree_size
    n_cells = tree_size(build_model(get_config("vgg9-cifar")).init(
        torch.Generator().manual_seed(0), "cpu"))
    t0 = clock()
    with tempfile.TemporaryDirectory() as d:
        mp.start_processes(pod_rank, args=(os.path.join(d, "store"), d,
                                           n_cells),
                           nprocs=2, start_method="spawn")
        outs = [torch.load(os.path.join(d, f"rank{r}.pt"),
                           weights_only=False) for r in range(2)]
    spawn_s = clock() - t0
    a, b = outs

    def same(x, y):
        if isinstance(x, dict):
            return x.keys() == y.keys() and all(same(x[k], y[k]) for k in x)
        if isinstance(x, (list, tuple)):
            return len(x) == len(y) and all(same(u, v) for u, v in zip(x, y))
        if isinstance(x, torch.Tensor):
            return torch.equal(x, y)
        return x == y

    # every output but each rank's own EF residual is the same on both
    for key in a:
        if key != "ef" and not same(a[key], b[key]):
            fail(f"13b: the two ranks' {key} differ")
    if not same([s for s, _ in a["ef"]], [s for s, _ in b["ef"]]):
        fail("13b: the two ranks' EF syncs differ")
    inputs = sync_inputs()

    def pods(tree, k):
        return [tree[k][r].cuda() for r in range(2)]

    for name, (inp, keep, quant) in SYNC_CASES.items():
        for k in inputs[inp]:
            want, _ = plain_sync(pods(inputs[inp], k), keep, quant)
            for r, out in enumerate(outs):
                if not torch.equal(out["sync"][name][k], want.cpu()):
                    fail(f"13b {name} {k}: rank {r} differs from the plain "
                         f"sync in this process")
    collision = float(a["sync"]["collision"]["w"][1])
    if abs(collision - 4.0) > 0.5:
        fail(f"13b collision: {collision}, expected about 4.0 (the kept "
             f"zero level counts in the denominator)")
    gauss = inputs["gauss"]
    for k in gauss:
        exact = (gauss[k][0].cuda() + gauss[k][1].cuda()) / 2
        if not torch.equal(a["exact"][k], exact.cpu()):
            fail(f"13b exact {k}: the mean sync differs from (g0 + g1) / 2")
        res = [torch.zeros_like(x) for x in pods(gauss, k)]
        for i in range(2):
            corrected = [x + r for x, r in zip(pods(gauss, k), res)]
            want, sent = plain_sync(corrected, 0.25, True)
            res = [c - s for c, s in zip(corrected, sent)]
            for r, out in enumerate(outs):
                if not (torch.equal(out["ef"][i][0][k], want.cpu())
                        and torch.equal(out["ef"][i][1][k], res[r].cpu())):
                    fail(f"13b ef step {i} {k}: rank {r} differs from the "
                         f"plain EF sync")
    u, m, w = (t.cuda() for t in cell_inputs(n_cells))
    cells_err = float((a["cells"].cuda() - ref.aio_aggregate_ref(u, m, w))
                      .abs().max())
    if not cells_err <= 1e-5:
        fail(f"13b: mesh_cell_aggregate {cells_err} from the stacked Eq. 5")
    if a["cell_launches"]["aio_absorb"] != SYNC_CELLS // 2:
        fail(f"13b: #7 launched {a['cell_launches']['aio_absorb']} times on "
             f"a rank, expected {SYNC_CELLS // 2}")
    if a["sync_launches"]["aio_aggregate"] == 0:
        fail("13b: the sync launched no #6")
    want_rounds, stream_launches = hier_run("streaming")
    got_rounds, mesh_launches = a["hier"]
    for (gl, gn, gc, gb), (wl, wn, wc, wb) in zip(got_rounds, want_rounds):
        if (gn, gc, gb) != (wn, wc, wb) or not math.isclose(
                gl, wl, rel_tol=1e-3):
            fail(f"13b: the mesh route's rounds {got_rounds} against the "
                 f"streaming route's {want_rounds}")
    n_rows = sum(-(-n // 2) for _, n, _, _ in got_rounds)
    if mesh_launches["aio_absorb"] != n_rows or mesh_launches["aio_merge"] \
            or mesh_launches["aio_aggregate"]:
        fail(f"13b: the mesh route launched {json.dumps(mesh_launches)} on a "
             f"rank, expected #7 {n_rows} times (its block of each round's "
             f"updates), #6 and #8 never")
    print(f"[sync] 13b two ranks over gloo on cuda:0 ({spawn_s:.3f} s, the "
          f"spawn included): {', '.join(SYNC_CASES)}, exact and two EF "
          f"steps bit for bit against the plain sync here; collision "
          f"{collision!r}; mesh_cell_aggregate I={SYNC_CELLS}, N={n_cells} "
          f"(vgg9-cifar) {cells_err!r} from the stacked Eq. 5, #7 "
          f"{a['cell_launches']['aio_absorb']} a rank; the 4-cell "
          f"hierarchy on the mesh route: losses "
          f"{[r[0] for r in got_rounds]} against the streaming route's "
          f"{[r[0] for r in want_rounds]}, launches a rank "
          f"{json.dumps(mesh_launches)} (streaming "
          f"{json.dumps(stream_launches)}); both ranks bit for bit",
          flush=True)
    return {"13b sync": a["sync_launches"], "13b cells": a["cell_launches"],
            "13b mesh route": mesh_launches}


def distributed_phase(auto: dict | None = None) -> dict:
    """Phase 13: the compressed cross-pod sync (see the module docstring).
    ``auto`` is phase 12b's result, run here when not given.  Returns the
    launches of each phase-13 path."""
    import tempfile

    import torch
    import torch.distributed as dist
    from repro_torch.device import resolve_device
    from repro_torch.kernels import build
    from repro_torch.launch import mesh as pmesh

    resolve_device("cuda")
    build.build_all()        # before the spawn: the ranks never build
    t_phase = clock()
    if auto is None:
        auto = train_full("12b", "phi3-mini-3.8b", 4, 1024)
    by_path = {}
    with tempfile.TemporaryDirectory() as d:
        dist.init_process_group(
            "nccl", store=dist.FileStore(os.path.join(d, "store"), 1),
            rank=0, world_size=1, device_id=torch.device("cuda", 0))
        try:
            r13a = sync_card_cpu()
            by_path["13a anycost step"] = r13a["launches"]
            free()
            r13c = train_full("13c", "phi3-mini-3.8b", 4, 1024,
                              mesh=pmesh.make_pod_mesh(1))
            by_path["13c phi3 anycost"] = r13c["launches"]
        finally:
            dist.destroy_process_group()
    if r13c["launches"]["aio_aggregate"] == 0:
        fail("13c: the anycost steps launched no #6")
    print(f"[sync] 13c phi3-mini-3.8b B=4, S=1024, anycost at keep_frac "
          f"{SYNC_KEEP} against 12b's auto step: {r13c['step_ms']:.3f} / "
          f"{auto['step_ms']:.3f} ms a step, {r13c['tok_s']:.1f} / "
          f"{auto['tok_s']:.1f} tokens/s, peak {r13c['peak_gib']:.3f} / "
          f"{auto['peak_gib']:.3f} GiB; the sync {r13c['sync_ms']:.3f} ms, "
          f"{r13c['sync_share']:.4f} of the step; #6 "
          f"{r13c['sync_launches']:.1f} launches a step; losses "
          f"{[round(x, 4) for x in r13c['losses']]}", flush=True)
    by_path.update(two_pods_on_one_card())
    wall = clock() - t_phase
    print(f"[sync] phase 13: {wall:.3f} s of wall time", flush=True)
    return by_path


#: phase 14, logical-axis sharding on DTensor.  14a and 14c on a
#: one-rank mesh equal their unsharded runs (12a's card step, 12b's
#: losses) bit for bit; 14b on two ranks of one card at 12a's bounds
#: (TRAIN_LOSS_ATOL, TRAIN_GRAD_RTOL) of the unsharded card step; 14d's
#: first loss, two tensor-parallel ranks in bf16 against 14c's one, within
#: SHARD_BF16_LOSS_ATOL (measured 5.3e-4 on the card: bf16 products
#: summed in another split of the model axis).
SHARD_BF16_LOSS_ATOL = 5e-3
SHARD_D_STEPS = 3
#: 14b's further sharded steps, each (arch, (data, model)): the MoE's
#: products under remat full on a model-sharded mesh, and qwen2-7b's on a
#: data-sharded batch, both refused on the card while the sharding
#: context was thread-local; the SSM's on a data-sharded batch and with
#: its inner width over "model", where its low-rank dt products run on
#: local shards (the two at once, (2, 2), only 14f traces)
SHARD_B_CASES = (("granite-moe-1b-a400m", (1, 2)),
                 ("qwen2-7b", (2, 1)),
                 ("falcon-mamba-7b", (2, 1)),
                 ("falcon-mamba-7b", (1, 2)))


def sharded_reduced(tag: str, mesh, arch: str = "qwen2-7b") -> dict:
    """14a and 14b: reduced float32 ``arch`` as 12a (one CPU
    initialisation copied to the card, B=2, S=64), one AdamW step
    unsharded on the card and one under ``use_sharding(mesh)`` with
    parameters and state placed by ``steps.param_shardings``: the losses,
    the gradient leaves (a recording optimizer) and the updated
    parameters, whole; every local shard's device and share of its leaf.
    Returns the unsharded and sharded results and the sharded step's
    launches."""
    import numpy as np
    import torch
    from repro_torch import sharding as shd
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import steps
    from repro_torch.models.registry import build_model
    from repro_torch.train.optimizer import Optimizer, adamw
    from repro_torch.utils.pytree import tree_leaves, tree_map
    cfg = get_config(arch).reduced()
    model = build_model(cfg)
    cpu = model.init(torch.Generator().manual_seed(0), "cpu")
    batch = {"tokens": torch.tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 64)), dtype=torch.int32).cuda()}
    opt = adamw(POD_LR, warmup=POD_WARMUP)

    def whole(t):
        return t.full_tensor() if shd.is_dtensor(t) else t

    def run(params, state):
        seen = {}

        def update(p, g, s):
            seen["grads"] = [whole(x).cpu() for x in tree_leaves(g)]
            return opt.update(p, g, s)

        step = steps.make_train_step(model, Optimizer(opt.init, update),
                                     remat="full")
        params, state, loss = step(params, state, batch)
        return {"loss": float(loss), "grads": seen["grads"],
                "params": [whole(x).cpu() for x in tree_leaves(params)]}

    plain = tree_map(lambda t: t.to("cuda", copy=True), cpu)
    want = run(plain, opt.init(plain))
    with shd.use_sharding(mesh):
        pshard = steps.param_shardings(model)
        sharded = steps.distribute(tree_map(lambda t: t.to(
            "cuda", copy=True), cpu), pshard)
        for path, t, s in zip([p for p, _ in cache_leaves(cpu)],
                              tree_leaves(sharded), tree_leaves(pshard)):
            local = t.to_local()
            share = math.prod(shd.local_shape(t.shape, s.spec))
            if local.device.type != "cuda" or local.numel() != share:
                fail(f"{tag}: leaf {path}'s local shard {tuple(local.shape)} "
                     f"on {local.device}, expected {share} elements of "
                     f"{tuple(t.shape)} ({s.spec}) on the card")
        state = steps.distribute(opt.init(sharded),
                                 steps.opt_state_shardings(opt, model))
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        got = run(sharded, state)
        torch.cuda.synchronize()
        launches = ops.launch_counts()
    return {"want": want, "got": got, "launches": launches,
            "n_sharded": sum(any(p.is_shard() for p in s.placements)
                             for s in tree_leaves(pshard))}


def compare_runs(want: dict, got: dict) -> tuple:
    """(loss difference, the largest gradient leaf difference over the
    leaf's largest |g|, the largest parameter difference)."""
    loss = abs(got["loss"] - want["loss"])
    grads = 0.0
    for x, y in zip(got["grads"], want["grads"]):
        scale = float(y.abs().max())
        err = float((x.float() - y.float()).abs().max())
        grads = max(grads, err / scale if scale > 0 else err)
    params = max(float((x.float() - y.float()).abs().max())
                 for x, y in zip(got["params"], want["params"]))
    return loss, grads, params


def train_sharded(label: str, arch: str, B: int, S: int, mesh,
                  n_steps: int) -> dict:
    """14c and 14d: 12b's recipe (published widths, seeded card
    parameters and tokens, ``adamw(POD_LR, warmup=POD_WARMUP)``, remat
    full) for ``n_steps`` steps under ``use_sharding(mesh)``, parameters
    and state placed by their shardings.  Step ms by CUDA events (the
    median of steps 2 on), tokens/s, the peak memory of this rank.
    Returns the numbers it printed."""
    import statistics

    import torch
    from repro_torch import sharding as shd
    from repro_torch.kernels import ops
    from repro_torch.launch import steps
    from repro_torch.train.optimizer import adamw
    from repro_torch.utils.pytree import tree_leaves
    free()
    model, params = build_full(arch, tag="shard")
    cfg = model.cfg
    gen = torch.Generator(device="cuda").manual_seed(12)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S),
                                     generator=gen, device="cuda",
                                     dtype=torch.int32)}
    opt = adamw(POD_LR, warmup=POD_WARMUP)
    with shd.use_sharding(mesh):
        params = steps.distribute(params, steps.param_shardings(model))
        free()
        state = steps.distribute(opt.init(params),
                                 steps.opt_state_shardings(opt, model))
        step = steps.make_train_step(model, opt, remat="full")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        starts, ends, losses = [], [], []
        t0 = clock()
        for _ in range(n_steps):
            starts.append(torch.cuda.Event(enable_timing=True))
            ends.append(torch.cuda.Event(enable_timing=True))
            starts[-1].record()
            params, state, loss = step(params, state, batch)
            ends[-1].record()
            losses.append(loss)
        torch.cuda.synchronize()
        wall = clock() - t0
        launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    local = sum(t.to_local().numel() * t.element_size()
                for t in tree_leaves(params)) / 2**30
    step_ms = [a.elapsed_time(b) for a, b in zip(starts, ends)]
    losses = [float(x) for x in torch.stack(losses).cpu()]
    if not all(math.isfinite(x) for x in losses):
        fail(f"{label} {arch}: non-finite loss {losses}")
    ms = statistics.median(step_ms[1:])
    out = {"losses": losses, "step_ms": ms, "tok_s": B * S * 1e3 / ms,
           "peak_gib": peak, "param_gib": local, "launches": launches,
           "n_layers": cfg.n_layers, "wall_s": wall}
    print(f"[shard] {label} {arch} ({cfg.n_layers} layers, full depth) "
          f"B={B}, S={S} on {dict(shd.mesh_shape(mesh))}: {n_steps} steps "
          f"in {wall:.3f} s, losses {losses}; step {ms:.3f} ms (median of "
          f"steps 2-{n_steps}; all {[round(x, 3) for x in step_ms]}), "
          f"{out['tok_s']:.1f} tokens/s; this rank's parameters "
          f"{local:.3f} GiB, peak memory {peak:.3f} GiB; launches "
          f"{json.dumps(launches)}", flush=True)
    del model, params, state, step, batch
    free()
    return out


@contextlib.contextmanager
def watch_combines():
    """#6's wrapper watched within the block: the list it yields gains
    the gathered values, mask, weights and output of every combine."""
    from repro_torch.kernels import ops
    seen, real = [], ops.aio_aggregate_op

    def watched(u, m, w):
        out = real(u, m, w)
        seen.append((u, m, w, out))
        return out

    ops.aio_aggregate_op = watched
    try:
        yield seen
    finally:
        ops.aio_aggregate_op = real


def check_combines(seen: list) -> list:
    """Each combine that :func:`watch_combines` kept, held against
    ``aio_aggregate_ref`` on the same tensors: ``[(I, N), coordinates
    kept, elements that differ, max abs err]`` for each."""
    import torch
    from repro_torch.kernels import ref
    res = []
    for u, m, w, got in seen:
        want = ref.aio_aggregate_ref(u, m, w)
        res.append([list(u.shape), int((m != 0).sum()),
                    int((got != want).sum()),
                    float((got - want).abs().max())])
    torch.cuda.synchronize()
    return res


def shard_rank(rank: int, store: str, out_dir: str) -> None:
    """One of 14b and 14d's two ranks: a gloo group over a ``FileStore``,
    every tensor on ``cuda:0``; what it computed goes to
    ``out_dir/rank{rank}.pt``."""
    import torch
    import torch.distributed as dist
    from repro_torch import sharding as shd
    from repro_torch.configs.base import InputShape
    from repro_torch.device import resolve_device
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as pmesh
    from repro_torch.launch import steps
    from repro_torch.models.registry import build_model
    from repro_torch.configs import get_config
    from repro_torch.train.optimizer import Optimizer, sgd
    from repro_torch.utils.pytree import tree_leaves, tree_map
    resolve_device("cuda")
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(store, 2),
                            rank=rank, world_size=2)
    out = {}
    host = pmesh.make_host_mesh()
    if host.device_type != "cuda":
        fail(f"14b: the gloo host mesh says {host.device_type!r}")
    r = sharded_reduced("14b", host)
    out["tp"] = {"diff": compare_runs(r["want"], r["got"]),
                 "launches": r["launches"], "n_sharded": r["n_sharded"]}
    free()
    for arch, shape in SHARD_B_CASES:
        r = sharded_reduced("14b", pmesh.make_mesh(
            shape, ("data", "model"), "cuda"), arch)
        out[arch, shape] = {"diff": compare_runs(r["want"], r["got"]),
                            "launches": r["launches"],
                            "n_sharded": r["n_sharded"]}
        free()
    # the "anycost" step sharded on (pod=2, data=1, model=1) against the
    # one-rank-a-pod step, on the same pod blocks
    model = build_model(get_config("qwen2-7b").reduced())
    cpu = model.init(torch.Generator().manual_seed(0), "cpu")
    import numpy as np
    batch = {"tokens": torch.tensor(np.random.default_rng(1).integers(
        0, 512, (4, 64)), dtype=torch.int32).cuda()}
    shape = InputShape("t", 64, 4, "train")
    mesh = pmesh.make_anycost_mesh(2)
    runs = {}
    for name, m in (("sharded", mesh), ("pods", pmesh.make_pod_mesh(2))):
        seen = {}
        opt = sgd(POD_LR)

        def update(p, g, s, seen=seen, opt=opt):
            seen["grads"] = [(x.full_tensor() if shd.is_dtensor(x) else x)
                             .cpu() for x in tree_leaves(g)]
            return opt.update(p, g, s)

        step = steps.make_train_step(model, Optimizer(opt.init, update),
                                     remat="full", grad_sync="anycost",
                                     keep_frac=SYNC_KEEP, mesh=m)
        params = tree_map(lambda t: t.to("cuda", copy=True), cpu)
        torch.cuda.synchronize()
        if name == "sharded":
            with shd.use_sharding(m, steps.rules_for(shape, "anycost")):
                params = steps.distribute(params,
                                          steps.param_shardings(model))
                ops.reset_launch_counts()
                with watch_combines() as combines:
                    _, _, loss = step(params, opt.init(params), batch)
                    torch.cuda.synchronize()
                runs["launches"] = ops.launch_counts()
            runs["combines"] = check_combines(combines)
        else:
            _, _, loss = step(params, opt.init(params), batch)
        runs[name] = {"loss": float(loss), "grads": seen["grads"]}
    runs["n_leaves"] = len(tree_leaves(cpu))
    out["anycost"] = runs
    del model, cpu
    free()
    out["14d"] = train_sharded("14d", "phi3-mini-3.8b", 4, 1024, host,
                               SHARD_D_STEPS)
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()


def two_ranks_sharded(first_loss: float) -> dict:
    """14b and 14d: spawns :func:`shard_rank` twice and checks what they
    computed.  Returns the launches by path and 14d's numbers."""
    import tempfile

    import torch
    import torch.multiprocessing as mp
    t0 = clock()
    with tempfile.TemporaryDirectory() as d:
        mp.start_processes(shard_rank, args=(os.path.join(d, "store"), d),
                           nprocs=2, start_method="spawn")
        outs = [torch.load(os.path.join(d, f"rank{r}.pt"),
                           weights_only=False) for r in range(2)]
    spawn_s = clock() - t0
    for r, out in enumerate(outs):
        loss, grads, params = out["tp"]["diff"]
        if not (loss <= TRAIN_LOSS_ATOL and grads <= TRAIN_GRAD_RTOL):
            fail(f"14b rank {r}: the sharded step against the unsharded "
                 f"card step, loss {loss} (bound {TRAIN_LOSS_ATOL}), "
                 f"gradients {grads} (bound {TRAIN_GRAD_RTOL})")
        if any(out["tp"]["launches"].values()):
            fail(f"14b: the sharded step launched {out['tp']['launches']}")
        for case in SHARD_B_CASES:
            loss, grads, _ = out[case]["diff"]
            if not (loss <= TRAIN_LOSS_ATOL and grads <= TRAIN_GRAD_RTOL):
                fail(f"14b rank {r}: {case[0]} sharded on {case[1]} against "
                     f"the unsharded card step, loss {loss} (bound "
                     f"{TRAIN_LOSS_ATOL}), gradients {grads} (bound "
                     f"{TRAIN_GRAD_RTOL})")
            if any(out[case]["launches"].values()):
                fail(f"14b: {case[0]}'s sharded step on {case[1]} launched "
                     f"{out[case]['launches']}")
        a = out["anycost"]
        same = a["sharded"]["loss"] == a["pods"]["loss"] and all(
            torch.equal(x, y) for x, y in zip(a["sharded"]["grads"],
                                              a["pods"]["grads"]))
        if not same:
            fail(f"14b rank {r}: the sharded anycost step differs from the "
                 f"one-rank-a-pod step")
        if a["launches"]["aio_aggregate"] != a["n_leaves"]:
            fail(f"14b rank {r}: #6 launched {a['launches']['aio_aggregate']}"
                 f" times in the sharded anycost step, expected one a "
                 f"gradient leaf ({a['n_leaves']})")
        bad = [c for c in a["combines"] if c[2] or not c[1]]
        if len(a["combines"]) != a["n_leaves"] or bad:
            fail(f"14b rank {r}: #6 in the sharded anycost step against "
                 f"aio_aggregate_ref on the same local shards: "
                 f"{len(a['combines'])} combines of {a['n_leaves']} "
                 f"leaves, not bit for bit or keeping nothing: {bad}")
    if outs[0]["14d"]["losses"] != outs[1]["14d"]["losses"]:
        fail(f"14d: the two ranks' losses differ: "
             f"{outs[0]['14d']['losses']} / {outs[1]['14d']['losses']}")
    d14 = outs[0]["14d"]
    first = abs(d14["losses"][0] - first_loss)
    if not first <= SHARD_BF16_LOSS_ATOL:
        fail(f"14d: the first loss {d14['losses'][0]} against 14c's "
             f"{first_loss}: {first} > {SHARD_BF16_LOSS_ATOL}")
    tp = outs[0]["tp"]
    n6 = outs[0]["anycost"]["launches"]["aio_aggregate"]
    combines = [c for o in outs for c in o["anycost"]["combines"]]
    print(f"[shard] 14b two gloo ranks on cuda:0 ({spawn_s:.3f} s, the "
          f"spawn and 14d included): reduced float32 qwen2-7b on (data=1, "
          f"model=2), {tp['n_sharded']} leaves sharded, every local shard "
          f"on the card with its spec's share; against the unsharded card "
          f"step loss {tp['diff'][0]!r}, gradients {tp['diff'][1]!r} of a "
          f"leaf's largest |g|, parameters {tp['diff'][2]!r}; the anycost "
          f"step on (pod=2, data=1, model=1) equals the one-rank-a-pod "
          f"step bit for bit, #6 {n6} times (one a leaf); each of the "
          f"{len(combines)} combines of the two ranks, on local shards "
          f"from (I, N) = {min(c[0] for c in combines)} to "
          f"{max(c[0] for c in combines)}, equals aio_aggregate_ref on the "
          f"same tensors ({sum(c[2] for c in combines)} elements differ, "
          f"max abs err {max(c[3] for c in combines)!r}, "
          f"{sum(c[1] for c in combines)} coordinates kept)", flush=True)
    for arch, shape in SHARD_B_CASES:
        o = outs[0][arch, shape]
        print(f"[shard] 14b {arch} reduced float32 on (data={shape[0]}, "
              f"model={shape[1]}), remat full, {o['n_sharded']} leaves "
              f"sharded: against the unsharded card step loss "
              f"{o['diff'][0]!r}, gradients {o['diff'][1]!r} of a leaf's "
              f"largest |g|, parameters {o['diff'][2]!r} (both ranks "
              f"within {TRAIN_LOSS_ATOL} / {TRAIN_GRAD_RTOL})", flush=True)
    print(f"[shard] 14d phi3-mini-3.8b on two ranks of one card: first "
          f"loss {d14['losses'][0]!r} against 14c's {first_loss!r} "
          f"({first!r}, bound {SHARD_BF16_LOSS_ATOL}); per-rank peaks "
          f"{[round(o['14d']['peak_gib'], 3) for o in outs]} GiB, step "
          f"{[round(o['14d']['step_ms'], 3) for o in outs]} ms", flush=True)
    return {"by_path": {"14b sharded step": tp["launches"],
                        **{f"14b {arch} {shape}": outs[0][arch, shape][
                            "launches"] for arch, shape in SHARD_B_CASES},
                        "14b anycost": outs[0]["anycost"]["launches"],
                        "14d phi3 two ranks": d14["launches"]},
            "14d": d14, "peaks": [o["14d"]["peak_gib"] for o in outs]}


def dryrun_pairs() -> list:
    """14e: the dry-run CLI at production mesh size, the two pairs in
    subprocesses beside each other, on ``meta`` tensors over a fake
    process group.  Returns its result lines."""
    import tempfile
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
    pairs = (["--arch", "qwen2-7b", "--shape", "train_4k", "--mesh",
              "single"],
             ["--arch", "phi3-mini-3.8b", "--shape", "train_4k", "--mesh",
              "multi", "--grad-sync", "anycost"])
    lines = []
    with tempfile.TemporaryDirectory() as d:
        t0 = clock()
        procs = [subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", *argv,
             "--out", d], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, start_new_session=True)
            for argv in pairs]
        CHILDREN.extend(procs)
        for argv, proc in zip(pairs, procs):
            stdout, stderr = proc.communicate(timeout=600)
            ok = [x for x in stdout.splitlines() if x.startswith("[OK]")]
            if proc.returncode != 0 or not ok:
                fail(f"14e: dryrun {' '.join(argv)} rc {proc.returncode}: "
                     f"{stdout[-1500:]} {stderr[-1500:]}")
            name = "__".join([argv[1], argv[3], argv[5], "baseline"])
            with open(os.path.join(d, name + ".json")) as f:
                res = json.load(f)
            r = res["roofline"]
            counts = {k: v["count"]
                      for k, v in res["collectives"]["by_op"].items()}
            line = (f"[shard] 14e dryrun {' '.join(argv)} (both pairs "
                    f"{clock() - t0:.3f} s, this trace "
                    f"{res['lower_s']} s): {res['mesh_desc']}, per-rank "
                    f"flops {r['flops']:.4e} (trace {r['hlo_flops']:.4e}), "
                    f"HBM bytes {r['hbm_bytes']:.4e}, wire bytes "
                    f"{r['collective_wire_bytes']:.4e}; compute "
                    f"{r['t_compute']:.4e} s, memory {r['t_memory']:.4e} s, "
                    f"collective {r['t_collective']:.4e} s -> "
                    f"{r['bottleneck']}; rank 0's argument bytes "
                    f"{res['memory_analysis']['argument_size_in_bytes']}; "
                    f"collectives {json.dumps(counts)}")
            print(line, flush=True)
            lines.append(line)
    return lines


#: 14f: ``tests/test_torch_dryrun.py``'s reduced (arch, kind, grad_sync)
#: pairs and input shapes, traced on a fake (pod=2, data=2, model=2) group
DRY_PAIRS = (("qwen2-7b", "train", "auto"),
             ("falcon-mamba-7b", "train", "auto"),
             ("granite-moe-1b-a400m", "train", "auto"),
             ("recurrentgemma-9b", "decode", "auto"),
             ("pixtral-12b", "prefill", "auto"),
             ("seamless-m4t-large-v2", "decode", "auto"),
             ("granite-moe-1b-a400m", "train", "anycost"))
DRY_SCRIPT = r"""
import json, sys
from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh

arch, kind, gs = sys.argv[1:4]
shapes = {"train": ("mini_train", 64, 8, "train"),
          "decode": ("mini_decode", 128, 8, "decode"),
          "prefill": ("mini_prefill", 64, 8, "prefill")}
dryrun.fake_group(8)
mesh = make_mesh((2, 2, 2), ("pod", "data", "model"), "cpu")
tr = dryrun.trace_step(get_config(arch).reduced(), InputShape(*shapes[kind]),
                       mesh, remat="none", grad_sync=gs)
coll = tr["collectives"]
print(json.dumps({"flops": tr["flops"], "wire": coll.wire_bytes,
                  "trace_s": tr["trace_s"],
                  "collectives": {k: d["count"]
                                  for k, d in coll.by_op.items()}}))
"""


def start_reduced_dryruns() -> list:
    """14f's traces, each pair in a subprocess of its own, started."""
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
    procs = [(pair, subprocess.Popen(
        [sys.executable, "-c", DRY_SCRIPT, *pair], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True)) for pair in DRY_PAIRS]
    CHILDREN.extend(proc for _, proc in procs)
    return procs


def reduced_dryruns() -> None:
    """14f: the seven reduced pairs on the card machine's torch; each
    must trace with flops and collectives."""
    t0 = clock()
    for pair, proc in start_reduced_dryruns():
        stdout, stderr = proc.communicate(timeout=600)
        name = " ".join(pair)
        if proc.returncode != 0:
            fail(f"14f: the reduced dry-run {name}: rc {proc.returncode}: "
                 f"{stderr[-3000:]}")
        r = json.loads(stdout.strip().splitlines()[-1])
        if not (r["flops"] > 0 and sum(r["collectives"].values()) > 0):
            fail(f"14f: the reduced dry-run {name} traced {r}")
        print(f"[shard] 14f reduced dry-run {name} on (pod=2, data=2, "
              f"model=2): per-rank flops {r['flops']:.6e}, wire bytes "
              f"{r['wire']:.6e}, collectives {json.dumps(r['collectives'])}"
              f", trace {r['trace_s']:.3f} s", flush=True)
    print(f"[shard] 14f: the seven pairs side by side in "
          f"{clock() - t0:.3f} s", flush=True)


def sharding_phase(auto: dict | None = None,
                   example_dryrun: bool = False) -> dict:
    """Phase 14: logical-axis sharding on DTensor (see the module
    docstring).  ``auto`` is phase 12b's result, run here when not
    given.  With ``example_dryrun``, phase 15's dry-run example starts
    before 14e, its CPU traces beside 14e's and 14f's.  Returns the
    launches of each phase-14 path (and the example's process)."""
    import tempfile

    import torch
    import torch.distributed as dist
    from repro_torch.device import resolve_device
    from repro_torch.kernels import build
    from repro_torch.launch import mesh as pmesh

    resolve_device("cuda")
    build.build_all()        # before the spawn: the ranks never build
    t_phase = clock()
    if auto is None:
        auto = train_full("12b", "phi3-mini-3.8b", 4, 1024)
    by_path = {}
    with tempfile.TemporaryDirectory() as d:
        dist.init_process_group(
            "nccl", store=dist.FileStore(os.path.join(d, "store"), 1),
            rank=0, world_size=1, device_id=torch.device("cuda", 0))
        try:
            host = pmesh.make_host_mesh()
            r = sharded_reduced("14a", host)
            loss, grads, params = compare_runs(r["want"], r["got"])
            if loss or grads or params or any(r["launches"].values()):
                fail(f"14a: the one-rank sharded step against the unsharded "
                     f"card step: loss {loss}, gradients {grads}, "
                     f"parameters {params} (all 0 expected); launches "
                     f"{r['launches']}")
            print(f"[shard] 14a reduced float32 qwen2-7b, one-rank NCCL "
                  f"host mesh: the sharded step equals the unsharded card "
                  f"step bit for bit (loss, {len(r['got']['grads'])} "
                  f"gradient leaves, parameters); launches "
                  f"{json.dumps(r['launches'])}", flush=True)
            by_path["14a sharded step"] = r["launches"]
            c = train_sharded("14c", "phi3-mini-3.8b", 4, 1024, host,
                              POD_STEPS)
            by_path["14c phi3 sharded"] = c["launches"]
        finally:
            dist.destroy_process_group()
    if c["losses"] != auto["losses"]:
        fail(f"14c: the sharded losses {c['losses']} are not 12b's "
             f"{auto['losses']} bit for bit")
    if any(c["launches"].values()):
        fail(f"14c: launches {c['launches']}")
    print(f"[shard] 14c phi3-mini-3.8b on the one-rank host mesh: losses "
          f"equal 12b's bit for bit; step {c['step_ms']:.3f} / "
          f"{auto['step_ms']:.3f} ms (sharded / 12b), {c['tok_s']:.1f} / "
          f"{auto['tok_s']:.1f} tokens/s, peak {c['peak_gib']:.3f} / "
          f"{auto['peak_gib']:.3f} GiB", flush=True)
    two = two_ranks_sharded(c["losses"][0])
    by_path.update(two["by_path"])
    for path in ("14b sharded step", "14d phi3 two ranks",
                 *(f"14b {arch} {shape}" for arch, shape in SHARD_B_CASES)):
        if any(by_path[path].values()):
            fail(f"{path}: launches {by_path[path]}")
    example = start_example_dryrun() if example_dryrun else None
    dry = dryrun_pairs()
    reduced_dryruns()
    wall = clock() - t_phase
    print(f"[shard] phase 14: {wall:.3f} s of wall time", flush=True)
    return {"by_path": by_path, "14c": c, "14d": two["14d"],
            "peaks": two["peaks"], "dryrun": dry, "wall_s": wall,
            "example_dryrun": example}


#: phase 15: each in-process example, its arguments (the defaults: its
#: published sizes) and the report lines it must print
EXAMPLES = (
    ("quickstart", (), ("after 1 round", "uplink")),
    ("heterogeneous_fleet", (),
     ("method        best_acc  total_time(s)", "anycostfl", "stc",
      "heterofl")),
    ("async_fleet", (), ("--- sync ---", "--- semisync ---",
                         "--- fedbuff ---",
                         "policy      best_acc  sim_time(s)  merges")),
    ("dynamic_fleet", (), ("static : acc=", "dynamic: acc=",
                           "dispatches)")),
    ("hier_cells", (), ("flat  best_acc=", "hier  best_acc=",
                        "backhaul_mb")),
    ("mobile_fleet", (), ("nearest handover", "peak occupancy",
                          "replayed scenario")),
    ("telemetry_run", (), ("trace signatures identical: True",
                           "round records identical:    True",
                           "manifest valid: True (backend=cuda",
                           "(components sum to the round totals")),
    ("anycost_serving", (), ("width  params%  test-acc (no retraining)",
                             "transformer width-elastic serving",
                             "logits finite=True")),
)


def run_example(name: str, argv: tuple) -> tuple[str, float, dict]:
    """``examples/torch_<name>.py`` run in this process with ``argv``,
    its standard output captured: (output, host seconds, launches)."""
    import io
    import runpy

    import torch
    from repro_torch.kernels import ops
    path = os.path.join(HERE, "examples", f"torch_{name}.py")
    saved = sys.argv, torch.backends.cudnn.deterministic, \
        torch.backends.cudnn.benchmark
    buf = io.StringIO()
    sys.argv = [path, *argv]
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = clock()
    try:
        with contextlib.redirect_stdout(buf):
            runpy.run_path(path, run_name="__main__")
        torch.cuda.synchronize()
    except SystemExit as e:
        fail(f"15: examples/torch_{name}.py exited with {e.code}: "
             f"{buf.getvalue()[-2000:]}")
    finally:
        (sys.argv, torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = saved
    return buf.getvalue(), clock() - t0, ops.launch_counts()


def start_example_dryrun():
    """``examples/torch_multipod_dryrun.py`` at its defaults (qwen2-7b
    train_4k on both production meshes) in a subprocess, started."""
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
    proc = subprocess.Popen(
        [sys.executable, os.path.join(HERE, "examples",
                                      "torch_multipod_dryrun.py")],
        cwd=HERE, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, start_new_session=True)
    CHILDREN.append(proc)
    return proc


def examples_phase(dry=None) -> dict:
    """Phase 15 (see the module docstring).  ``dry`` is the dry-run
    example's process if it was started earlier, else it starts here.
    Returns each example's launches."""
    from repro_torch.device import resolve_device
    from repro_torch.kernels import build
    resolve_device("cuda")
    build.build_all()
    t_phase = clock()
    dry = dry or start_example_dryrun()
    by_path = {}
    for name, argv, lines in EXAMPLES:
        out, secs, launches = run_example(name, argv)
        missing = [x for x in lines if x not in out]
        if missing:
            fail(f"15: examples/torch_{name}.py printed none of {missing}: "
                 f"{out[-2000:]}")
        if name == "quickstart":
            feasible = sum(x.startswith("device ") and "infeasible" not in x
                           for x in out.splitlines())
            want = {k: 0 for k in launches}
            want.update(kernel_sumsq=feasible, kernel_l2=feasible,
                        fused_sparsify_quantize=feasible, aio_aggregate=1)
            if launches != want or not feasible:
                fail(f"15: the quickstart's launches {launches}, expected "
                     f"{want} ({feasible} feasible devices)")
        by_path[f"15 {name}"] = launches
        last = out.strip().splitlines()[-1]
        print(f"[examples] torch_{name}.py: {secs:.3f} s of host wall "
              f"time; launches {json.dumps(launches)}; last line: {last}",
              flush=True)
    stdout, stderr = dry.communicate(timeout=900)
    roofs = [x for x in stdout.splitlines() if "bottleneck=" in x]
    # the example echoes each trace's last line; without both [OK]s the
    # roofline lines could come from an earlier run's result files
    traced = all(f"[OK] qwen2-7b x train_4k ({mesh})" in stdout
                 for mesh in ("single", "multi"))
    if dry.returncode != 0 or len(roofs) != 2 or not traced:
        fail(f"15: examples/torch_multipod_dryrun.py rc {dry.returncode}: "
             f"{stdout[-2000:]} {stderr[-2000:]}")
    for line in roofs:
        print(f"[examples] torch_multipod_dryrun.py:{line}", flush=True)
    secs = clock() - t_phase
    print(f"[examples] phase 15: {secs:.3f} s of wall time (the dry-run "
          f"example's traces beside the others)", flush=True)
    return {"by_path": by_path, "wall_s": secs}


def surface_pytree(dev) -> float:
    """16a: the pytree helpers on the card against the CPU; returns the
    largest relative difference of ``tree_dot``."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model
    from repro_torch.utils import pytree as T
    model = build_model(get_config("fmnist-cnn"))
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        cpu = [T.tree_cast(model.init(torch.Generator().manual_seed(s),
                                      "cpu"), dtype) for s in (0, 1)]
        card = [T.tree_map(lambda x: x.to(dev), t) for t in cpu]

        def same(label, got, want):
            g, w = T.tree_leaves(got), T.tree_leaves(want)
            if len(g) != len(w) or not all(
                    a.device.type == "cuda" and a.dtype == b.dtype
                    and torch.equal(a.cpu(), b) for a, b in zip(g, w)):
                fail(f"16a {dtype}: {label} differs on the card")
        if not T.tree_bytes(card[0]) == T.tree_bytes(cpu[0]) \
                == 1_663_370 * card[0]["conv1"]["w"].element_size():
            fail(f"16a {dtype}: tree_bytes {T.tree_bytes(card[0])}")
        same("tree_zeros_like", T.tree_zeros_like(card[0]),
             T.tree_zeros_like(cpu[0]))
        same("tree_add", T.tree_add(*card), T.tree_add(*cpu))
        same("tree_scale", T.tree_scale(card[0], 0.3),
             T.tree_scale(cpu[0], 0.3))
        same("tree_cast", T.tree_cast(card[0], torch.float32),
             T.tree_cast(cpu[0], torch.float32))
        same("map_named", T.map_named(lambda n, x: x * len(n), card[0]),
             T.map_named(lambda n, x: x * len(n), cpu[0]))
        if [n for n, _ in T.named_leaves(card[0])] \
                != [n for n, _ in T.named_leaves(cpu[0])]:
            fail(f"16a {dtype}: named_leaves differs on the card")
        absd = [T.tree_map(torch.abs, t) for t in (card[1], cpu[1])]
        for label, got, want in (
                ("p.p", T.tree_dot(card[0], card[0]),
                 T.tree_dot(cpu[0], cpu[0])),
                ("|q|.|q|", T.tree_dot(absd[0], absd[0]),
                 T.tree_dot(absd[1], absd[1]))):
            if got.device.type != "cuda" or got.dtype != want.dtype:
                fail(f"16a {dtype}: tree_dot {label} on {got.device}, "
                     f"{got.dtype}")
            rel = abs(float(got) - float(want)) / abs(float(want))
            worst = max(worst, rel)
            if rel > 1e-6:
                fail(f"16a {dtype}: tree_dot {label} {float(got)!r} on the "
                     f"card, {float(want)!r} on the CPU")
        for bad in (None, float("nan"), float("inf")):
            t = T.tree_map(torch.clone, card[0])
            if bad is not None:
                t["dense1"]["w"][3, 5] = bad
            flag = T.tree_any_nan(t)
            if flag.device.type != "cuda" or bool(flag) != (bad is not None):
                fail(f"16a {dtype}: tree_any_nan {bool(flag)} with {bad}")
    return worst


def surface_conv(dev) -> float:
    """16c: strided conv2d on the card against the CPU; returns the
    largest absolute difference."""
    import torch
    from repro_torch.models import cnn
    gen = torch.Generator().manual_seed(5)
    p = cnn.init_conv(gen, 5, 5, 32, 64)
    p["b"] = torch.rand(64, generator=gen)
    worst = 0.0
    for size in (15, 14):
        x = torch.rand(4, 32, size, size + 1, generator=gen)
        for padding in ("SAME", "VALID"):
            want = cnn.conv2d(p, x, stride=2, padding=padding)
            got = cnn.conv2d({k: v.to(dev) for k, v in p.items()}, x.to(dev),
                             stride=2, padding=padding)
            torch.cuda.synchronize()
            got = got.cpu()
            if got.shape != want.shape or not torch.allclose(
                    got, want, rtol=1e-5, atol=1e-5):
                fail(f"16c: conv2d stride 2 {padding} at {size}: "
                     f"{tuple(got.shape)} against {tuple(want.shape)}, "
                     f"{float((got - want).abs().max())}")
            worst = max(worst, float((got - want).abs().max()))
    return worst


def surface_phase(n_rho: int, n_levels: int) -> dict:
    """Phase 16 (see the module docstring).  Returns the validator run's
    launches."""
    import dataclasses as dc
    import importlib.util

    import numpy as np
    import torch
    from repro_torch.core import schedule
    from repro_torch.device import resolve_device
    from repro_torch.kernels import build, ops
    from repro_torch.sysmodel import population
    dev = resolve_device("cuda")
    build.build_all()
    t_phase = clock()
    dot_rel = surface_pytree(dev)
    print(f"[surface] 16a: pytree helpers on the card equal the CPU's, "
          f"tree_dot within {dot_rel:.3e}", flush=True)
    rng = np.random.default_rng(12)
    fleet = population.make_fleet(
        rng, population.FleetConfig(n_devices=N_DEVICES),
        np.full(N_DEVICES, 128))
    envs = fleet.round_envs(rng, 1e6, 3.2e7)
    got = [dc.asdict(s) for s in schedule.solve_population(envs)]
    if got != [dc.asdict(schedule.solve(e)) for e in envs] \
            or len(got) != N_DEVICES:
        fail("16b: solve_population differs from solve")
    print(f"[surface] 16b: solve_population equals {N_DEVICES} solve calls "
          f"({sum(s['feasible'] for s in got)} feasible)", flush=True)
    conv_err = surface_conv(dev)
    print(f"[surface] 16c: conv2d stride 2, SAME and VALID, 15 and 14 "
          f"rows, card against CPU within {conv_err:.3e}", flush=True)
    spec = importlib.util.spec_from_file_location(
        "validate_telemetry_torch",
        os.path.join(HERE, "scripts", "validate_telemetry_torch.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = clock()
    try:
        hist = script.main(["--run"])
        torch.cuda.synchronize()
    except SystemExit as e:
        fail(f"16d: validate_telemetry_torch.py --run exited with {e.code}")
    secs = clock() - t0
    launches = ops.launch_counts()
    want = expected_launches(script.tiny_configs()[0], hist, n_rho,
                             n_levels, hier=True)
    if launches != want or not launches["aio_absorb"] \
            or not launches["aio_merge"] or launches["aio_aggregate"]:
        fail(f"16d: the validator's run launched {json.dumps(launches)}, "
             f"expected {json.dumps(want)} (#7 and #8, no #6)")
    print(f"[surface] 16d: validate_telemetry_torch.py --run on the card "
          f"{secs:.3f} s; launches {json.dumps(launches)}", flush=True)
    wall = clock() - t_phase
    print(f"[surface] phase 16: {wall:.3f} s of wall time", flush=True)
    return {"16 validator": launches}


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
                                         grouped_mm, ops, quantize, ref,
                                         sparsify)
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

    t_script = clock()
    dev = torch.device("cuda")
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}",
          flush=True)

    # ---------------------------------------------------------------- 1
    t0 = clock()
    built = build.build_all()
    print(f"[build] nvcc built {built} in {clock() - t0:.2f} s",
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
    # neither path launches the LM experts' grouped GEMM
    fl_kernels = set(ops.launch_counts()) - set(grouped_mm.launches)
    expected = {"flat": fl_kernels - {"aio_absorb", "aio_merge"},
                "hier": fl_kernels - {"aio_aggregate"}}
    grids = inspect.signature(compression.BetaPlanner.fit).parameters
    n_rho = len(grids["rho_grid"].default)
    n_levels = len(grids["level_grid"].default)
    counts, walls = {}, {}
    for kind, fleet in paths.items():
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = clock()
        hist = run_fl(cfg, fleet, device="cuda")
        torch.cuda.synchronize()
        walls[kind] = clock() - t0
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
    t0 = clock()
    compression.BetaPlanner.fit(probe, rand)
    torch.cuda.synchronize()
    fit_ms = (clock() - t0) * 1e3
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
    # --------------------------------------------------------------- 10
    serving_phase()
    # --------------------------------------------------------------- 11
    recurrent_phase()
    # --------------------------------------------------------------- 12
    pod = pod_phase()
    # --------------------------------------------------------------- 13
    by_path.update(distributed_phase(pod["12b"]))
    # --------------------------------------------------------------- 14
    shard = sharding_phase(pod["12b"], example_dryrun=True)
    by_path.update(shard["by_path"])
    # --------------------------------------------------------------- 15
    by_path.update(examples_phase(shard["example_dryrun"])["by_path"])
    # --------------------------------------------------------------- 16
    by_path.update(surface_phase(n_rho, n_levels))
    print(f"[time] chip_smoke.py: {clock() - t_script:.3f} s of wall "
          f"time, the build included", flush=True)
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
