"""Smoke run of the PyTorch port on one CUDA card.

  python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. Build the port's CUDA kernels from ``src/repro_torch/kernels/csrc``
   (one ``nvcc`` per source, all at once) and print the build seconds
   and the compiler's register report.
2. Hold every kernel function against its plain PyTorch version on the
   card, at the shapes the fmnist-cnn update gives it (N = 1,663,370
   parameters in 8 leaves, K = 622 FGC kernels; 12 devices at the
   server).  Tolerances: level indices, the keep mask, the threshold step
   and the streaming absorb/merge exact (the last two must also write
   into the caller's storage); norms rtol 1e-5 (the plain version sums
   in another order); dequantized values and the batched aggregate rtol
   1e-6.
3. Agreement on small inputs: a 3-device flat run and a 4-device, 2-cell
   hierarchical run, each for 2 rounds on the card and on the CPU (plain
   versions), same seed, same uniforms.  Strategies, cells reporting and
   backhaul bits exact; bits and losses rtol 1e-3 (cuDNN sums in another
   order, which can flip a level index); accuracy within 0.05.
4. The main paths, each with every launch counter zeroed just before and
   read just after, fmnist-cnn at full width, 12 devices, 3 rounds,
   n_train 1536, the beta planner on, eval every round:
   (a) ``run_fl`` on the flat fleet: kernels #1-#6 must have launched,
       #3/#4 through the planner fit;
   (b) ``run_fl`` on ``TopologyConfig(kind="hier", n_cells=4)``: #7 and
       #8 must have launched and #6 must not; every round reports 4 cells
       and ships 4 f32 partials.
   Losses must be finite and the final parameters finite CUDA tensors of
   the model's shapes.
5. Time each kernel, its plain version and, where one PyTorch call
   computes the same function, that call (CUDA events, back to back, so
   the inputs may sit in the 50 MB L2), beside the least time the card
   could take (bytes moved over 3.35 TB/s, or float32 operations over
   67 TFLOP/s, whichever is larger), and print both runs' host wall time.

The last lines are the card's name and power limit, one JSON object of
kernels, and the result line.  Without a card, or without the rest of
the repository beside this file, it exits non-zero and prints no result.
"""
from __future__ import annotations

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
FMNIST_SHAPES = [(32,), (5, 5, 1, 32), (64,), (5, 5, 32, 64), (512,),
                 (3136, 512), (10,), (512, 10)]
N_DEVICES = 12
N_CELLS = 4


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


def cuda_ms(fn, iters: int = 50, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(n_bytes: float, n_flops: float) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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
        from repro_torch.core.aggregation import optimal_coefficients
        from repro_torch.kernels import (aio_agg, build, fused_compress,
                                         ops, quantize, ref, sparsify)
        from repro_torch.orchestrator import runner
        from repro_torch.orchestrator.policies import (OrchestratorConfig,
                                                       SyncPolicy)
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

    norms = torch.cat([sparsify.kernel_l2(x) for x in views])
    thr = compression.sparsify_threshold(norms, 0.8)
    thr_f = float(thr)
    keep = (norms >= thr).float()
    mask_views, k0 = [], 0
    for x in views:
        mask_views.append(keep[k0:k0 + x.shape[0], None].expand(x.shape))
        k0 += x.shape[0]
    mask = compression._from_views(mask_views)
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
    checks["fused_sparsify_quantize"] = fused_err

    # threshold_apply per leaf into its slot of one flat buffer (the
    # planner's call), then prob_quantize over the flat masked vector
    masked = torch.empty(n, device=dev)
    thr_err, k0 = 0.0, 0
    for x, out in zip(views, compression._leaf_views(masked, FMNIST_SHAPES)):
        nk = norms[k0:k0 + x.shape[0]]
        got, kp = sparsify.threshold_apply(x, nk, thr_f, out=out)
        want, want_kp = ref.threshold_mask_ref(x, nk, thr_f)
        if got.data_ptr() != out.data_ptr():
            fail("threshold_apply did not write into the given slot")
        if not (torch.equal(got, want) and torch.equal(kp, want_kp)):
            fail("threshold_apply differs from its plain version")
        thr_err = max(thr_err, float((got - want).abs().max()))
        k0 += x.shape[0]
    checks["threshold_apply"] = thr_err
    qargs = (masked, mask, float(u_min), float(u_max), 64.0, rand)
    q4, l4 = quantize.prob_quantize(*qargs)
    q4r, l4r = ref.quantize_ref(*qargs)
    if not torch.equal(l4, l4r):
        fail(f"prob_quantize: level indices differ at "
             f"{int((l4 != l4r).sum())} elements")
    torch.testing.assert_close(q4, q4r, rtol=1e-6, atol=0)
    checks["prob_quantize"] = float((q4 - q4r).abs().max())

    # the streaming pair, in place, bit for bit
    num = torch.randn(n, generator=gen, device=dev) * 1e-3
    den = torch.rand(n, generator=gen, device=dev)
    upd = torch.randn(n, generator=gen, device=dev) * 1e-2
    msk = (torch.rand(n, generator=gen, device=dev) > 0.4).float()
    ptrs = (num.data_ptr(), den.data_ptr())
    want = ref.aio_absorb_ref(num, den, upd, msk, 3.7184)
    aio_agg.aio_absorb(num, den, upd, msk, 3.7184)
    if (num.data_ptr(), den.data_ptr()) != ptrs:
        fail("aio_absorb did not update the accumulator in place")
    if not (torch.equal(num, want[0]) and torch.equal(den, want[1])):
        fail("aio_absorb differs from its plain version")
    checks["aio_absorb"] = max(float((num - want[0]).abs().max()),
                               float((den - want[1]).abs().max()))
    num_b, den_b = upd.clone(), msk.clone()
    want = ref.aio_merge_ref(num, den, num_b, den_b)
    aio_agg.aio_merge(num, den, num_b, den_b)
    if (num.data_ptr(), den.data_ptr()) != ptrs:
        fail("aio_merge did not update the accumulator in place")
    if not (torch.equal(num, want[0]) and torch.equal(den, want[1])):
        fail("aio_merge differs from its plain version")
    checks["aio_merge"] = max(float((num - want[0]).abs().max()),
                              float((den - want[1]).abs().max()))

    u = torch.randn(N_DEVICES, n, generator=gen, device=dev) * 1e-2
    m = (torch.rand(N_DEVICES, n, generator=gen, device=dev) > 0.4).float()
    alphas = [(0.25, 0.4, 0.55, 0.7, 0.85, 1.0)[i % 6]
              for i in range(N_DEVICES)]
    betas = [0.002 * (i + 1) for i in range(N_DEVICES)]
    w = optimal_coefficients(alphas, betas).to(dev)
    agg = aio_agg.aio_aggregate(u, m, w)
    agg_ref = ref.aio_aggregate_ref(u, m, w)
    torch.testing.assert_close(agg, agg_ref, rtol=1e-6, atol=0)
    checks["aio_aggregate"] = float((agg - agg_ref).abs().max())
    torch.cuda.synchronize()
    print(f"[check] kernels against plain versions, max abs err: "
          f"{json.dumps(checks)}", flush=True)

    # ---------------------------------------------------------------- 3
    class CpuDrawnUniforms:
        """Uniforms drawn on the CPU and moved to the run's device, so a
        CPU run and a CUDA run get the same numbers."""

        def __init__(self, seed, device):
            self.gen = torch.Generator().manual_seed(seed)
            self.device = device

        def _stream(self):
            return lambda k: torch.rand(k, generator=self.gen).to(
                self.device)

        planner_stream = device_stream = _stream

    small = FLRunConfig(rounds=2, n_train=128, n_test=64, eval_every=1,
                        lr=0.1, seed=3, use_planner=False)
    small_fleets = {
        "flat": FleetConfig(n_devices=3),
        "hier": FleetConfig(n_devices=4, topology=TopologyConfig(
            kind="hier", n_cells=2))}
    for kind, fleet in small_fleets.items():
        logs = {}
        for where in ("cpu", "cuda"):
            sim = runner.Simulation(small, fleet, device=where,
                                    uniforms=CpuDrawnUniforms(7, where))
            orch = OrchestratorConfig()
            logs[where] = runner._run_round_based(
                sim, SyncPolicy(orch), orch, False).rounds
        for c, g in zip(logs["cpu"], logs["cuda"]):
            if (c.mean_alpha, c.mean_gain, c.n_clients, c.n_cells_reporting,
                    c.backhaul_bits) != (g.mean_alpha, g.mean_gain,
                                         g.n_clients, g.n_cells_reporting,
                                         g.backhaul_bits):
                fail(f"small {kind} run: strategies or cells differ in "
                     f"round {c.round}")
            for f in ("comm_bits", "latency_s", "energy_j", "test_loss"):
                a, b = getattr(c, f), getattr(g, f)
                if not abs(a - b) <= 1e-3 * abs(a):
                    fail(f"small {kind} run: {f} {b} on the card vs {a} on "
                         f"the CPU")
            if abs(c.test_acc - g.test_acc) > 0.05:
                fail(f"small {kind} run: accuracy {g.test_acc} vs "
                     f"{c.test_acc}")
        print(f"[agree] {kind} {fleet.n_devices}-device 2-round "
              f"run, card vs CPU: comm_bits "
              f"{[r.comm_bits for r in logs['cuda']]} vs "
              f"{[r.comm_bits for r in logs['cpu']]}; test_loss "
              f"{[r.test_loss for r in logs['cuda']]} vs "
              f"{[r.test_loss for r in logs['cpu']]}; cells reporting "
              f"{[r.n_cells_reporting for r in logs['cuda']]}", flush=True)

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
    launches = dict(counts["flat"], aio_absorb=counts["hier"]["aio_absorb"],
                    aio_merge=counts["hier"]["aio_merge"])

    # ---------------------------------------------------------------- 5
    def per_leaf(fn):
        return lambda: [fn(x) for x in views]

    def fused_all(fn):
        def run():
            k0 = 0
            for x, r in zip(views, rviews):
                fn(x, norms[k0:k0 + x.shape[0]], *scal, r)
                k0 += x.shape[0]
        return run

    def threshold_all(fn, flat_out):
        outs = compression._leaf_views(flat_out, FMNIST_SHAPES) \
            if flat_out is not None else [None] * len(views)

        def run():
            k0 = 0
            for x, out in zip(views, outs):
                nk = norms[k0:k0 + x.shape[0]]
                if out is None:
                    fn(x, nk, thr_f)
                else:
                    fn(x, nk, thr_f, out=out)
                k0 += x.shape[0]
        return run

    rows = [
        dict(name="kernel_sumsq", source="src/repro_torch/kernels/csrc/"
             "sparsify.cu", replaces="src/repro/kernels/sparsify.py:36",
             ms=cuda_ms(per_leaf(sparsify.kernel_sumsq)),
             plain_ms=cuda_ms(per_leaf(ref.kernel_sumsq_ref)),
             library_ms=cuda_ms(per_leaf(
                 lambda x: torch.einsum("kc,kc->k", x, x))),
             tolerance="rtol 1e-5", bound=bound_ms(4 * n + 4 * K, 2 * n)),
        dict(name="kernel_l2", source="src/repro_torch/kernels/csrc/"
             "sparsify.cu", replaces="src/repro/kernels/sparsify.py:58",
             ms=cuda_ms(per_leaf(sparsify.kernel_l2)),
             plain_ms=cuda_ms(per_leaf(ref.kernel_l2_ref)),
             library_ms=cuda_ms(per_leaf(
                 lambda x: torch.linalg.vector_norm(x, dim=1))),
             tolerance="rtol 1e-5", bound=bound_ms(4 * n + 4 * K, 2 * n + K)),
        dict(name="fused_sparsify_quantize", source="src/repro_torch/"
             "kernels/csrc/fused_compress.cu",
             replaces="src/repro/kernels/fused_compress.py:43",
             ms=cuda_ms(fused_all(fused_compress.fused_sparsify_quantize)),
             plain_ms=cuda_ms(fused_all(ref.fused_sparsify_quantize_ref)),
             library_ms=None,
             tolerance="levels and support exact, values rtol 1e-6",
             bound=bound_ms(16 * n + 4 * K, 12 * n)),
        dict(name="aio_aggregate", source="src/repro_torch/kernels/csrc/"
             "aio_agg.cu", replaces="src/repro/kernels/aio_agg.py:53",
             ms=cuda_ms(lambda: aio_agg.aio_aggregate(u, m, w)),
             plain_ms=cuda_ms(lambda: ref.aio_aggregate_ref(u, m, w)),
             library_ms=None, tolerance="rtol 1e-6",
             bound=bound_ms(8 * N_DEVICES * n + 4 * N_DEVICES + 4 * n,
                            4 * N_DEVICES * n + n)),
    ]
    num_a, den_a = num.clone(), den.clone()
    rows += [
        dict(name="threshold_apply", source="src/repro_torch/kernels/csrc/"
             "sparsify.cu", replaces="src/repro/kernels/sparsify.py:70",
             ms=cuda_ms(threshold_all(sparsify.threshold_apply, masked)),
             plain_ms=cuda_ms(threshold_all(ref.threshold_mask_ref, None)),
             library_ms=None, tolerance="exact",
             bound=bound_ms(8 * n + 8 * K, n)),
        dict(name="prob_quantize", source="src/repro_torch/kernels/csrc/"
             "quantize.cu", replaces="src/repro/kernels/quantize.py:39",
             ms=cuda_ms(lambda: quantize.prob_quantize(*qargs)),
             plain_ms=cuda_ms(lambda: ref.quantize_ref(*qargs)),
             library_ms=None,
             tolerance="levels exact, values rtol 1e-6",
             bound=bound_ms(20 * n, 12 * n)),
        dict(name="aio_absorb", source="src/repro_torch/kernels/csrc/"
             "aio_agg.cu", replaces="src/repro/kernels/aio_agg.py:90",
             ms=cuda_ms(lambda: aio_agg.aio_absorb(num_a, den_a, upd, msk,
                                                   0.5)),
             plain_ms=cuda_ms(lambda: ref.aio_absorb_ref(num_a, den_a, upd,
                                                         msk, 0.5)),
             library_ms=None, tolerance="exact, in place",
             bound=bound_ms(24 * n, 4 * n)),
        dict(name="aio_merge", source="src/repro_torch/kernels/csrc/"
             "aio_agg.cu", replaces="src/repro/kernels/aio_agg.py:130",
             ms=cuda_ms(lambda: aio_agg.aio_merge(num_a, den_a, num_b,
                                                  den_b)),
             plain_ms=cuda_ms(lambda: ref.aio_merge_ref(num_a, den_a, num_b,
                                                        den_b)),
             library_ms=cuda_ms(lambda: torch._foreach_add_(
                 [num_a, den_a], [num_b, den_b])),
             tolerance="exact, in place", bound=bound_ms(24 * n, 2 * n)),
    ]
    kernels = []
    for r in rows:
        b, by = r.pop("bound")
        kernels.append(dict(
            name=r["name"], route="cuda", source=r["source"],
            replaces=r["replaces"], launches=launches[r["name"]],
            max_abs_err=checks[r["name"]], ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=b, bound_by=by,
            library_ms=r["library_ms"], tolerance=r["tolerance"]))
    for k in kernels:
        print(f"[time] {k['name']}: kernel {k['ms']:.6f} ms, plain "
              f"{k['plain_ms']:.6f} ms, library {k['library_ms']} ms, "
              f"bound {k['bound_ms']:.6f} ms ({k['bound_by']}), "
              f"{k['launches']} launches on the main path")

    print(f"[time] host wall time of the 3-round main-path runs: flat "
          f"{walls['flat']:.3f} s, hier {walls['hier']:.3f} s", flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
