"""Smoke run of the PyTorch port on one CUDA card.

  python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. Build the port's CUDA kernels from ``src/repro_torch/kernels/csrc``
   (one ``nvcc`` per source, all at once) and print the build seconds
   and the compiler's register report.
2. Hold every kernel of the main path against its plain PyTorch version
   on the card, at the shapes the fmnist-cnn update gives it
   (N = 1,663,370 parameters in 8 leaves, K = 622 FGC kernels; 12
   devices at the server).  Tolerances: level indices and the keep mask
   exact; norms rtol 1e-5 (the plain version sums in another order);
   dequantized values and the aggregate rtol 1e-6.
3. Agreement on a small input: a 3-device, 2-round run on the card and
   the same run on the CPU (plain versions), same seed, same uniforms.
   Strategies exact; bits and losses rtol 1e-3 (cuDNN sums in another
   order, which can flip a level index); accuracy within 0.05.
4. The main path: ``run_fl`` on the card, fmnist-cnn at full width, 12
   devices, 3 rounds, n_train 1536, the beta planner on, eval every
   round.  Every kernel's launch counter is zeroed just before and read
   just after; each must have risen.  Losses must be finite and the
   final parameters finite and of the model's shapes.
5. Time each kernel, its plain version and, where one PyTorch call
   computes the same function, that call (CUDA events, back to back, so
   the inputs may sit in the 50 MB L2), beside the least time the card
   could take (bytes moved over 3.35 TB/s, or float32 operations over
   67 TFLOP/s, whichever is larger).

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
                                         ops, ref, sparsify)
        from repro_torch.orchestrator import runner
        from repro_torch.orchestrator.policies import (OrchestratorConfig,
                                                       SyncPolicy)
        from repro_torch.sysmodel.population import FleetConfig
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
    logs = {}
    for where in ("cpu", "cuda"):
        sim = runner.Simulation(small, FleetConfig(n_devices=3),
                                device=where,
                                uniforms=CpuDrawnUniforms(7, where))
        orch = OrchestratorConfig()
        logs[where] = runner._run_round_based(sim, SyncPolicy(orch), orch,
                                              False).rounds
    for c, g in zip(logs["cpu"], logs["cuda"]):
        if (c.mean_alpha, c.mean_gain, c.n_clients) != \
                (g.mean_alpha, g.mean_gain, g.n_clients):
            fail(f"small run: strategies differ in round {c.round}")
        for f in ("comm_bits", "latency_s", "energy_j", "test_loss"):
            a, b = getattr(c, f), getattr(g, f)
            if not abs(a - b) <= 1e-3 * abs(a):
                fail(f"small run: {f} {b} on the card vs {a} on the CPU")
        if abs(c.test_acc - g.test_acc) > 0.05:
            fail(f"small run: accuracy {g.test_acc} vs {c.test_acc}")
    print(f"[agree] 3-device 2-round run, card vs CPU: comm_bits "
          f"{[r.comm_bits for r in logs['cuda']]} vs "
          f"{[r.comm_bits for r in logs['cpu']]}; test_loss "
          f"{[r.test_loss for r in logs['cuda']]} vs "
          f"{[r.test_loss for r in logs['cpu']]}", flush=True)

    # ---------------------------------------------------------------- 4
    cfg = FLRunConfig(rounds=3, n_train=1536, n_test=384, eval_every=1,
                      seed=0, use_planner=True)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    hist = run_fl(cfg, FleetConfig(n_devices=N_DEVICES), device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    print(f"[main] run_fl fmnist-cnn, {N_DEVICES} devices, {cfg.rounds} "
          f"rounds, n_train {cfg.n_train}, planner on: {wall:.3f} s on the "
          f"host clock, first round's planner fit and warm-up included",
          flush=True)
    for r in hist.rounds:
        print(f"[main] round {r.round}: n_clients={r.n_clients} "
              f"mean_alpha={r.mean_alpha:.4f} mean_beta={r.mean_beta:.6f} "
              f"comm_bits={r.comm_bits:.1f} latency_s={r.latency_s:.4f} "
              f"energy_j={r.energy_j:.4f} flops={r.flops:.4g} "
              f"test_acc={r.test_acc} test_loss={r.test_loss}")
    print(f"[main] launches: {json.dumps(launches)}", flush=True)
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        fail(f"the main path never launched {missing}")
    if not all(r.test_loss is not None and math.isfinite(r.test_loss)
               for r in hist.rounds):
        fail("a round's test loss is not finite")
    final = tree_leaves(hist.final_params)
    if [tuple(t.shape) for t in final] != FMNIST_SHAPES:
        fail(f"final parameter shapes {[tuple(t.shape) for t in final]}")
    if not all(bool(torch.isfinite(t).all()) and t.device.type == "cuda"
               for t in final):
        fail("final parameters are not finite CUDA tensors")

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

    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
