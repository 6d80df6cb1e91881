"""What decides ``correct``: what the program produced in the checked
rounds, judged stage by stage by the plain reference, each number beside
its limit.

Local SGD at the cells' learning rate is chaotic: two float32 runs that
differ only in the order of a convolution's sums (one client alone, or a
lane of the pool's ``vmap``) part by 0.1-0.3 of an update within ten
steps.  So the reference cannot follow the program's rounds on its own;
it follows them stage by stage from the program's state
(``reference/fl.follow``), and every local step of the sampled devices
from the sub-model the program's step started from.  A :class:`Capture`
holds, per checked round ``t``:

* ``params_in``: the global model the round starts from;
* ``plan``, ``batch``: each dispatched device's bucketed width and target
  rate, and its minibatches' checksums (image sum, label sum);
* ``steps``: each trained device's minibatch checksums step by step, as
  its local SGD took them, and for the devices :func:`inputs.step_sample`
  draws in each width the sub-model each step started from;
* ``trained``: each device's sub-model after its local steps, as the
  round loop hands it on;
* ``bits``: each device's modelled wire size;
* ``sent``: for the devices sampled from the seed, the uploaded values
  and transmitted mask, flat;
* ``partial`` (hierarchical): each cell's per-leaf ``num``/``den`` norms;
* ``new``: the global model after the server step;
* ``eval``: the test-set accuracy and loss of ``new``.
"""
from __future__ import annotations

import torch

from bench import inputs


def leaf_norms(tensors) -> list[float]:
    """float64 L2 norms, one host read."""
    return torch.stack([torch.linalg.vector_norm(x.detach().double())
                        for x in tensors]).tolist()


def leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    return [tree]


def to_host(tree):
    if isinstance(tree, dict):
        return {k: to_host(v) for k, v in tree.items()}
    return tree.detach().cpu()


def split(vec, numels):
    out, off = [], 0
    for n in numels:
        out.append(vec[off:off + n])
        off += n
    return out


def batch_sums(images, labels) -> tuple[float, int]:
    return float(images.double().sum()), int(labels.long().sum())


class Capture:
    def __init__(self):
        self.rounds: dict[int, dict] = {}

    def r(self, t):
        return self.rounds.setdefault(t, {
            "plan": {}, "batch": {}, "steps": {}, "trained": {}, "bits": {},
            "sent": {}, "partial": {}})

    def device_steps(self, t, i):
        return self.r(t)["steps"].setdefault(i, {"sums": [], "states": []})

    # a stand-in's record(kind, ...) callback
    def __call__(self, kind, *a):
        t, rest = a[0], a[1:]
        r = self.r(t)
        if kind in ("params_in", "new"):
            r[kind] = to_host(rest[0])
        elif kind == "eval":
            r["eval"] = (float(rest[0]), float(rest[1]))
        elif kind == "plan":
            r["plan"][rest[0]] = (float(rest[1]), float(rest[2]))
        elif kind == "batch":
            r["batch"][rest[0]] = batch_sums(rest[1], rest[2])
        elif kind == "step":
            # (device, minibatch sums, the sub-model the step starts from
            # or None)
            i, sums, state = rest
            d = self.device_steps(t, i)
            d["sums"].append(sums)
            if state is not None:
                d["states"].append(to_host(state))
        elif kind == "trained":
            r["trained"][rest[0]] = to_host(rest[1])
        elif kind == "bits":
            r["bits"][rest[0]] = float(rest[1])
        elif kind == "sent":
            r["sent"][rest[0]] = (rest[1].detach().float().cpu(),
                                  (rest[2].detach() > 0).cpu())
        elif kind == "partial":
            k, num, den, numels = rest
            r["partial"][k] = (leaf_norms(split(num, numels)),
                               leaf_norms(split(den, numels)))


class ProgramRecorder:
    """The program side: an ``observe`` callback for ``program.Hooks``
    that fills a :class:`Capture`."""

    def __init__(self, cap: Capture, sample, numels):
        self.cap = cap
        self.sample = set(sample)
        self.numels = numels
        self.t = 0

    def __call__(self, name, args, kwargs, out):
        from repro_torch.utils.pytree import flat_vector
        t, cap = self.t, self.cap
        if name == "sort_params":
            cap("params_in", t, args[0])
        elif name == "prepare" and out is not None:
            cap("plan", t, out.client_id, out.alpha, out.strat.beta)
            cap("batch", t, out.client_id, out.batches["images"],
                out.batches["labels"])
        elif name == "materialize":
            p = args[0]
            cap("trained", t, p.client_id, args[1])
            cap("bits", t, p.client_id, p.update.bits)
            if p.client_id in self.sample:
                cap("sent", t, p.client_id, flat_vector(p.update.values),
                    flat_vector(p.update.mask))
        elif name == "encode_ship":
            cap("partial", t, args[0], args[1].num, args[1].den,
                self.numels)
        elif name == "evaluate":
            cap("new", t, args[0])
            cap("eval", t, *out)


class StepTap:
    """Local SGD seen step by step in the checked rounds.

    The round loop trains a group of devices of one width either in the
    pool's vmapped step (``torch.func.vmap`` of the loss's gradient, once
    a step) or, for a group of one or without the pool, in the client's
    plain step (``loss_fn`` once a step).  The tap knows which devices a
    group trains from the pool's ``_run_group`` (or ``train_one``), and at
    each step records every device's minibatch checksums and, for the
    devices :func:`inputs.step_sample` draws, the sub-model the step
    starts from.  It only observes: each call gets its own arguments and
    returns its own result."""

    def __init__(self, prog, cap: Capture, seed: int, per_width: int):
        self.prog, self.cap = prog, cap
        self.seed, self.per_width = seed, per_width
        self.n_devices = len(prog.sim.fleet.data_sizes)
        self.t = 0
        self.group = None          # (device ids, sampled ids, plain)
        self._saved = []

    def _set(self, owner, name, value):
        self._saved.append((owner, name, owner.__dict__.get(name)))
        setattr(owner, name, value)

    def _open(self, ids, plain):
        pick = inputs.step_sample(self.seed, self.t, self.n_devices, ids,
                                  self.per_width)
        self.group = (list(ids), pick, plain)

    def __enter__(self):
        from repro_torch.core import anycost
        sim, tap = self.prog.sim, self
        run_group, train_one = sim.pool._run_group, sim.train_one
        vmap, loss_fn = torch.func.vmap, anycost.loss_fn

        def run_group_w(idxs, jobs, params, shared):
            tap._open([jobs[j].client_id for j in idxs], len(idxs) == 1)
            try:
                return run_group(idxs, jobs, params, shared)
            finally:
                tap.group = None

        def train_one_w(p, *a, **kw):
            tap._open([p.client_id], True)
            try:
                return train_one(p, *a, **kw)
            finally:
                tap.group = None

        def vmap_w(fn, *a, **kw):
            batched = vmap(fn, *a, **kw)
            group = tap.group
            if group is None or group[2]:
                return batched
            in_dims = kw.get("in_dims", a[0] if a else 0)
            shared = isinstance(in_dims, tuple) and in_dims[0] is None

            def call(p, batch, *rest):
                tap._lanes(p, batch, shared)
                return batched(p, batch, *rest)
            return call

        def loss_fn_w(model, params, batch, *a, **kw):
            group = tap.group
            if group is not None and group[2]:
                i = group[0][0]
                tap.cap("step", tap.t, i, batch_sums(batch["images"],
                                                     batch["labels"]),
                        params if i in group[1] else None)
            return loss_fn(model, params, batch, *a, **kw)

        self._set(sim.pool, "_run_group", run_group_w)
        self._set(sim, "train_one", train_one_w)
        self._set(torch.func, "vmap", vmap_w)
        self._set(anycost, "loss_fn", loss_fn_w)
        return self

    def _lanes(self, p, batch, shared):
        ids, pick, _ = self.group
        img = batch["images"].double().flatten(1).sum(1)
        lab = batch["labels"].long().flatten(1).sum(1)
        img, lab = img.tolist(), lab.tolist()
        if len(img) != len(ids):
            # lanes that are not the group's devices: nothing to follow
            ids = [-1 - k for k in range(len(img))]
        for lane, i in enumerate(ids):
            state = None
            if i in pick:
                state = p if shared else _lane(p, lane)
            self.cap("step", self.t, i, (img[lane], int(lab[lane])), state)

    def __exit__(self, *exc):
        for owner, name, old in reversed(self._saved):
            if old is None:
                delattr(owner, name)
            else:
                setattr(owner, name, old)
        self._saved = []
        return False


def _lane(tree, k):
    if isinstance(tree, dict):
        return {n: _lane(v, k) for n, v in tree.items()}
    return tree[k]


def judge(nums: dict[str, float], limits: dict[str, float]
          ) -> tuple[bool, dict[str, list]]:
    """(correct, {number: [reading, limit]}) over the numbers that have a
    limit; a reading that is not finite fails."""
    shown = {k: [nums[k], lim] for k, lim in limits.items()}
    ok = all(v == v and v <= lim for v, lim in shown.values())
    return ok, shown
