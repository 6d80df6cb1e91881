"""AnycostFL (and HeteroFL) rounds in plain PyTorch and NumPy, one device
at a time, worked out from the seed.

Per round, in the order the program consumes its generator: channel
draws, channel sorting, the beta planner's probe (first round), each
device's strategy and minibatches, local SGD on its shrunk sub-model,
the zero-padded update, FGC, Theorem 1's coefficients (FedAvg's sample
counts for HeteroFL) and Eq. 5 (flat: one weighted masked mean;
hierarchical: each cell's unnormalized ``(num, den)`` partial, summed in
cell order, then the ratio), the server step and the test-set
evaluation.  The quantization uniforms are the benchmark's input: the
caller hands in the same source it gives the program.

Two uses:

* :func:`follow` judges what the program produced (a ``bench.check``
  capture): it works the start out again (weights, strategies,
  minibatches, each step's minibatch, each width's shrunk sub-model),
  recomputes every local step of the sampled devices from the sub-model
  the program's step started from, and from the program's model at the
  round's start and each device's trained sub-model recomputes FGC,
  Eq. 5, the server step and the evaluation;
* :func:`simulate` runs whole rounds itself and records them as the
  program's would be recorded: the control (``mode="tf32"``) and the
  planted faults (``fault``) put in the program's place.
"""
from __future__ import annotations

import contextlib
import statistics
import types

import numpy as np
import torch

from bench import inputs
from reference import fgc, host, model as M

F32 = torch.float32


@contextlib.contextmanager
def precision(mode: str):
    """float32 products (TF32 off) or, for the control, TF32 on."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    on = mode == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


# ----------------------------------------------------------------- pieces

def _setup(cfg, wl, seed, dev):
    mdl, data, fl = cfg["model"], cfg["data"], cfg["fleet"]
    st = types.SimpleNamespace(mdl=mdl, wl=wl, dev=dev, method=wl["method"],
                               n_cells=wl["cells"])
    st.rng = rng = np.random.default_rng(seed)
    (st.tx, st.ty), (ex, ey) = host.image_task(
        rng, data["n_train"], data["n_test"], tuple(data["image_shape"]))
    st.parts = host.partition_iid(rng, data["n_train"], fl["n_devices"])
    st.fleet = host.Fleet(rng, fl, [len(p) for p in st.parts], st.n_cells)
    st.W = host.flops_per_sample(mdl)
    st.init = M.init_params(mdl, seed, dev)
    st.shapes = [tuple(x.shape) for x in M.leaves(st.init)]
    st.n_params = sum(x.numel() for x in M.leaves(st.init))
    st.tiers = host.heterofl_tiers(st.fleet.eps)
    st.test_x = torch.from_numpy(ex).to(dev)
    st.test_y = torch.from_numpy(ey).to(dev)
    return st


def _planner(st, sorted_p, uniforms):
    draw = uniforms.planner_stream()
    idx = st.rng.permutation(len(st.tx))[:16]
    with torch.enable_grad():
        probe = M.sgd(sorted_p, torch.from_numpy(st.tx[idx][None]).to(st.dev),
                      torch.from_numpy(st.ty[idx][None]).to(st.dev),
                      st.wl["lr"])
    return fgc.Planner(M.flat(sorted_p) - M.flat(probe), st.shapes,
                       draw(st.n_params))


def _dispatch(st, envs, uniforms):
    """[(device, strategy, bucketed alpha, uniform draw, batch indices)]"""
    jobs = []
    for i, env in enumerate(envs):
        if st.method == "anycostfl":
            strat = host.solve(env)
            if not strat.feasible:
                continue
        else:
            strat = host.fixed_width(
                env, host.HETEROFL_TIERS[int(st.tiers[i])], 1.0)
        draw = uniforms.device_stream()
        sel = host.device_batches(st.rng, st.parts[i], st.wl["batch_size"],
                                  st.wl["tau"])
        jobs.append((i, strat, host.bucket(strat.alpha), draw, sel))
    return jobs


def _batches(st, sel):
    return (torch.from_numpy(st.tx[sel]).to(st.dev),
            torch.from_numpy(st.ty[sel]).to(st.dev))


def _upload(st, sorted_p, alpha, beta, trained, draw, planner):
    """(values, mask, bits) of one device's update, flat."""
    local = M.tmap(torch.sub, M.shrink(sorted_p, st.mdl, alpha), trained)
    full, wmask = M.expand(local, st.mdl, alpha, sorted_p)
    vec, wvec = M.flat(full), M.flat(wmask)
    if st.method != "anycostfl":
        return vec * wvec, wvec, 32.0 * st.n_params
    rho, levels = planner.plan(float(beta))
    q, smask, bits = fgc.compress(vec, st.shapes, rho, levels,
                                  draw(st.n_params))
    mask = wvec * smask
    return q * mask, mask, float(bits)


def _weight(st, alpha, beta, n_samples):
    """The unnormalized coefficient: Theorem 1's 1 / max(d^2, 1e-12),
    d the float32 divergence factor (float32 for the flat weights,
    float64 for an edge's), or the sample count."""
    if st.method != "anycostfl":
        return torch.tensor(float(n_samples), dtype=F32)
    a = torch.tensor(alpha, dtype=F32)
    sb = torch.sqrt(torch.tensor(max(beta, 1e-6), dtype=F32).double()
                    ).to(F32)
    d = 1.0 - a * (2.0 - a) * sb
    if st.n_cells > 1:
        return torch.tensor(1.0 / max(float(d) ** 2, 1e-12),
                            dtype=torch.float64)
    return 1.0 / torch.clamp(d.square(), min=1e-12)


def _aggregate(st, sorted_p, ups, record_partial=None):
    """Eq. 5 and the server step over ``ups``: [(device, weight, values,
    mask)] -> the new global model."""
    n, dev = st.n_params, st.dev
    if st.n_cells == 1:
        w = torch.stack([u[1] for u in ups])
        if st.method == "anycostfl":          # normalized left to right
            total = w[0]
            for v in w[1:]:
                total = total + v
        else:
            total = w.sum()
        w = (w / total).to(dev)
        num, den = torch.zeros(n, device=dev), torch.zeros(n, device=dev)
        for j, (_, _, values, mask) in enumerate(ups):
            wm = w[j] * mask
            num, den = num + wm * values, den + wm
    else:
        cells = {}
        for i, wt, values, mask in ups:
            nd = cells.setdefault(st.fleet.cell_of(i),
                                  [torch.zeros(n, device=dev),
                                   torch.zeros(n, device=dev)])
            # the edge takes each coefficient as a float32 argument
            wm = torch.tensor(float(wt), dtype=F32, device=dev) * mask
            nd[0], nd[1] = nd[0] + wm * values, nd[1] + wm
        ks = sorted(cells)
        if record_partial is not None:
            for k in ks:
                record_partial(k, *cells[k])
        num, den = cells[ks[0]]
        for k in ks[1:]:
            num, den = num + cells[k][0], den + cells[k][1]
    agg = torch.where(den > 0, num / torch.clamp(den, min=1e-12),
                      torch.zeros((), device=dev))
    return M.unflat(sorted_p, M.flat(sorted_p) - agg)


def _evaluate(st, params):
    logits = M.forward(params, st.test_x)
    acc = float((logits.argmax(-1) == st.test_y).float().mean())
    logp = torch.log_softmax(logits.float(), dim=-1)
    return acc, float(-logp.gather(-1, st.test_y.long()[:, None]).mean())


def _to(tree, dev):
    return M.tmap(lambda x: x.to(dev), tree)


def _worst_leaf(p, r, scale=None):
    """max over leaves of |p - r| over the scale's norm of that leaf or
    of its median leaf, whichever is larger (the scale is ``r``)."""
    scale = r if scale is None else scale
    med = statistics.median(scale)
    return max(abs(a - b) / max(c, med, 1e-30)
               for a, b, c in zip(p, r, scale))


def _norms(tree_or_list):
    xs = M.leaves(tree_or_list) if isinstance(tree_or_list, dict) \
        else tree_or_list
    return [float(torch.linalg.vector_norm(x.double())) for x in xs]


# ----------------------------------------------------------------- follow

NUMBERS = ("start_mismatch", "step_gap", "step_diff", "mask_gap",
           "value_gap", "bits_gap", "partial_gap", "agg_gap", "loss_gap",
           "acc_gap")


def follow(config, workload, seed, uniforms, device, cap, rounds: int
           ) -> dict[str, float]:
    """Judge a capture of ``rounds`` checked rounds -> the numbers."""
    with precision("fp32"), torch.no_grad():
        return _follow(config, workload, seed, uniforms,
                       torch.device(device), cap, rounds)


def _step_sums(x, y):
    return [(float(x[s].double().sum()), int(y[s].long().sum()))
            for s in range(x.shape[0])]


def _sums_differ(a, b) -> bool:
    """Minibatch checksums: the label sums exactly, the image sums to
    float64 rounding (the program sums a lane of a stacked batch)."""
    return a[1] != b[1] or abs(a[0] - b[0]) > 1e-9 * max(abs(b[0]), 1.0)


def _steps(st, wl, sorted_p, alpha, x, y, got_steps, trained, out, worst):
    """Every local step of one sampled device, each from the sub-model the
    program's step started from: per leaf, the gap between the norms of
    the program's change and the reference's (``step_gap``) and the norm
    of their difference (``step_diff``), each over the reference's norm
    of that leaf or of the median leaf, whichever is larger."""
    states = got_steps["states"]
    n = x.shape[0]
    if len(states) != n:
        return False
    start = M.shrink(sorted_p, st.mdl, alpha)
    out["start_mismatch"] += sum(
        not torch.equal(a.to(st.dev), b)
        for a, b in zip(M.leaves(states[0]), M.leaves(start)))
    p = _to(states[0], st.dev)
    for s in range(n):
        nxt = _to(states[s + 1] if s + 1 < n else trained, st.dev)
        with torch.enable_grad():
            q = M.sgd(p, x[s:s + 1], y[s:s + 1], wl["lr"])
        mine = [b - a for a, b in zip(M.leaves(p), M.leaves(q))]
        theirs = [b - a for a, b in zip(M.leaves(p), M.leaves(nxt))]
        r = _norms(mine)
        g = _worst_leaf(_norms(theirs), r)
        d = _worst_leaf(_norms([a - b for a, b in zip(theirs, mine)]),
                        [0.0] * len(r), r)
        out["step_gap"] = max(out["step_gap"], g)
        out["step_diff"] = max(out["step_diff"], d)
        worst[alpha] = max(worst.get(alpha, 0.0), g)
        p = nxt
    return True


def _follow(cfg, wl, seed, uniforms, dev, cap, rounds):
    out = dict.fromkeys(NUMBERS, 0.0)
    inf = dict.fromkeys(NUMBERS, float("inf"))
    st = _setup(cfg, wl, seed, dev)
    if 0 not in cap.rounds or "params_in" not in cap.rounds[0]:
        return inf
    out["start_mismatch"] += sum(
        not torch.equal(a, b.cpu()) for a, b in
        zip(M.leaves(cap.rounds[0]["params_in"]), M.leaves(st.init)))
    planner, worst = None, {}
    for t in range(rounds):
        got = cap.rounds.get(t)
        if got is None or "params_in" not in got:
            return inf
        envs = st.fleet.round_envs(st.rng, st.W, 32.0 * st.n_params)
        sorted_p = M.sort_channels(_to(got["params_in"], dev), st.mdl)
        if planner is None and st.method == "anycostfl" \
                and wl["planner"]:
            planner = _planner(st, sorted_p, uniforms)
        jobs = _dispatch(st, envs, uniforms)
        mine = {i: (a, float(s.beta)) for i, s, a, _, _ in jobs}
        out["start_mismatch"] += sum(
            got["plan"].get(i) != mine.get(i)
            for i in set(mine) | set(got["plan"]))
        out["start_mismatch"] += len(set(got["steps"]) - set(mine))
        followed = set()
        ups = []
        for i, strat, alpha, draw, sel in jobs:
            x, y = _batches(st, sel)
            sums = (float(x.double().sum()), int(y.long().sum()))
            out["start_mismatch"] += got["batch"].get(i) != sums
            if i not in got["trained"]:
                continue
            dsteps = got["steps"].get(i, {"sums": [], "states": []})
            ref_sums = _step_sums(x, y)
            out["start_mismatch"] += len(ref_sums) != len(dsteps["sums"])
            out["start_mismatch"] += sum(
                _sums_differ(a, b) for a, b in zip(dsteps["sums"], ref_sums))
            if dsteps["states"]:
                if not _steps(st, wl, sorted_p, alpha, x, y, dsteps,
                              got["trained"][i], out, worst):
                    return inf
                followed.add(alpha)
            values, mask, bits = _upload(
                st, sorted_p, alpha, strat.beta,
                _to(got["trained"][i], dev), draw, planner)
            if i in got["bits"]:
                out["bits_gap"] = max(out["bits_gap"],
                                      abs(got["bits"][i] - bits) / bits)
            if i in got["sent"]:
                pv, pm = got["sent"][i]
                out["mask_gap"] = max(out["mask_gap"], float(
                    (pm != (mask > 0).cpu()).float().mean()))
                out["value_gap"] = max(out["value_gap"], _worst_leaf(
                    _norms(M.leaves(M.unflat(st.init, pv))),
                    _norms(M.leaves(M.unflat(st.init, values)))))
            ups.append((i, _weight(st, alpha, float(strat.beta),
                                   sel.size), values, mask))
        # every width that trained had its steps followed
        if {a for i, _, a, _, _ in jobs if i in got["trained"]} - followed:
            return inf
        if len(got["trained"]) != len(ups):
            return inf
        if not ups or "new" not in got:
            if bool(ups) != ("new" in got):
                return inf
            continue

        def partial(k, num, den):
            if k not in got["partial"]:
                out["partial_gap"] = float("inf")
                return
            pn, pd = got["partial"][k]
            out["partial_gap"] = max(
                out["partial_gap"],
                _worst_leaf(pn, _norms(M.leaves(M.unflat(st.init, num)))),
                _worst_leaf(pd, _norms(M.leaves(M.unflat(st.init, den)))))

        new = _aggregate(st, sorted_p, ups, partial)
        theirs = _to(got["new"], dev)
        out["agg_gap"] = max(out["agg_gap"], _worst_leaf(
            _norms(M.tmap(torch.sub, sorted_p, theirs)),
            _norms(M.tmap(torch.sub, sorted_p, new))))
        acc, loss = _evaluate(st, theirs)
        pa, pl = got["eval"]
        out["loss_gap"] = max(out["loss_gap"], abs(pl - loss) / abs(loss))
        out["acc_gap"] = max(out["acc_gap"], abs(pa - acc))
    # the worst step of each width, read beside the numbers
    for alpha in sorted(worst):
        out[f"step_gap.a{alpha:g}"] = worst[alpha]
    return out


# --------------------------------------------------------------- simulate

def simulate(config, workload, seed, uniforms, device, rounds: int,
             record, *, mode: str = "fp32", fault: str | None = None,
             sample=(), per_width: int = 2) -> None:
    """Whole rounds in the program's place, recorded as a
    ``bench.check.Capture`` records the program's (the steps of the
    ``per_width`` devices of each width that ``inputs.step_sample``
    draws).  ``fault``: ``frozen`` (each local step returns its state
    unchanged), ``half_batch`` (each step's loss over the first half of
    its minibatch), ``altered`` (the first uploading device's values
    doubled where they are produced)."""
    with precision(mode), torch.no_grad():
        _simulate(config, workload, seed, uniforms, torch.device(device),
                  rounds, record, fault, set(sample), per_width)


def _simulate(cfg, wl, seed, uniforms, dev, rounds, record, fault, sample,
              per_width):
    st = _setup(cfg, wl, seed, dev)
    numels = [x.numel() for x in M.leaves(st.init)]
    params, planner = st.init, None
    for t in range(rounds):
        envs = st.fleet.round_envs(st.rng, st.W, 32.0 * st.n_params)
        record("params_in", t, params)
        sorted_p = M.sort_channels(params, st.mdl)
        if planner is None and st.method == "anycostfl" \
                and wl["planner"]:
            planner = _planner(st, sorted_p, uniforms)
        jobs = _dispatch(st, envs, uniforms)
        picked = set()
        for a in {job[2] for job in jobs}:
            picked |= inputs.step_sample(
                seed, t, len(st.parts), [job[0] for job in jobs
                                         if job[2] == a], per_width)
        ups = []
        for i, strat, alpha, draw, sel in jobs:
            x, y = _batches(st, sel)
            record("plan", t, i, alpha, strat.beta)
            record("batch", t, i, x, y)
            sub = M.shrink(sorted_p, st.mdl, alpha)

            def on_step(s, p, i=i, x=x, y=y):
                record("step", t, i, (float(x[s].double().sum()),
                                      int(y[s].long().sum())),
                       p if i in picked else None)
            with torch.enable_grad():
                trained = M.sgd(sub, x, y, wl["lr"], fault, on_step)
            record("trained", t, i, trained)
            values, mask, bits = _upload(st, sorted_p, alpha, strat.beta,
                                         trained, draw, planner)
            if fault == "altered" and not ups:
                values = values * 2.0
            record("bits", t, i, bits)
            if i in sample:
                record("sent", t, i, values, mask)
            ups.append((i, _weight(st, alpha, float(strat.beta), sel.size),
                        values, mask))
        if not ups:
            continue
        params = _aggregate(
            st, sorted_p, ups,
            lambda k, num, den: record("partial", t, k, num, den, numels))
        record("new", t, params)
        record("eval", t, *_evaluate(st, params))
