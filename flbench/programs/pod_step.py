"""The pod step: the port's LM train step (``launch/steps.make_train_step``)
on one pod, as ``launch/train.run_pod`` sets it up, with the anycost
gradient sync across pods (``core/distributed.anycost_gradient_sync``)
and AdamW.  A round is one call of the step: this pod's forward and
backward on its batch, the sync of every gradient leaf, the update.

The configuration names the port's architecture (``model.name``) and
holds its sizes, which replace the port's own; its ``model.family``
names the plain reference, ``reference/lm_<family>.py``, whose layout
the benchmark draws the initial weights in (``bench/lm_inputs.py``):
the program's parameter tree must hold the same leaves.  The card runs
one pod (``pods`` 1) of a deployment of ``1 + peer_pods``: the pod group
is one rank, made in set-up on a ``FileStore`` in a temporary directory
(NCCL on the card, gloo on the CPU) and destroyed by
:meth:`PodStep.close`, and the sync's gather (``core/distributed.
_all_gather``) hands Eq. 5 this pod's row and the other pods' rows,
drawn from it by ``bench/lm_inputs.pod_rows``; the gather moves no bytes
between cards.

Set-up runs the cell's checked steps through :meth:`PodStep.round`, each
on its own rows, and records their losses, the first step's gradient as
the optimizer got it (its first moments over ``1 - b1``) and the
parameters' change over the checked steps (``reference/pod.py`` names
the record's keys); after the window :func:`follow` runs the reference
through the same steps from the same seed and compares.  The profiled
rounds annotate the step's three calls, ``flbench.grad``,
``flbench.sync`` and ``flbench.optim``, and their trace gives each one's
device time (``bench/trace.device_by_phase``); each Eq. 5 launch's
stack is recorded for #6's roofline.

:func:`control` and :func:`fault` give the upper readings of the
comparison's limits (``readings.py``): the reference in float8 products
put in the program's place, and the program with one of :data:`FAULTS`
planted.
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib
import os
import shutil
import tempfile

import torch

from bench import lm_inputs
from reference import pod as ref_pod

#: the configuration's ``model`` keys that set the port's architecture
#: (its family is the port's own for ``model.name``; ``model.family``
#: names the reference, whose layout the program's leaves must match)
ARCH_KEYS = ("n_layers", "d_model", "n_heads", "n_kv_heads",
             "head_dim", "d_ff", "vocab_size", "rope_theta", "dtype",
             "tie_embeddings")
#: the port's RMSNorm epsilon (``models/layers.norm``)
PORT_NORM_EPS = 1e-6
#: the flops' peak by the parameters' dtype (``roofline/peaks.json``)
PEAK_OF = {"bfloat16": "bf16_flops_per_s", "float32": "f32_flops_per_s"}
#: the step's calls the profiled rounds annotate: phase -> steps' name
PHASES = {"grad": "value_and_grad", "sync": "anycost_gradient_sync"}


def build(config: dict, traffic: dict, cell: dict, seed: int, device):
    return PodStep(config, traffic, cell, seed, device)


def flatten(tree, prefix: str = "") -> dict:
    """{dotted path: leaf} of a nested dict."""
    if not isinstance(tree, dict):
        return {prefix[:-1]: tree}
    out = {}
    for k in sorted(tree):
        out.update(flatten(tree[k], f"{prefix}{k}."))
    return out


def unflatten(leaves: dict) -> dict:
    out = {}
    for path, leaf in leaves.items():
        *outer, last = path.split(".")
        node = out
        for k in outer:
            node = node.setdefault(k, {})
        node[last] = leaf
    return out


class PodStep:
    def __init__(self, config, traffic, cell, seed, device):
        import torch.distributed as dist
        from repro_torch.configs import get_config
        from repro_torch.core import distributed as pdist
        from repro_torch.device import resolve_device
        from repro_torch.launch import mesh as pmesh, steps
        from repro_torch.models.registry import build_model
        from repro_torch.train.optimizer import Optimizer, adamw

        self.config, self.traffic, self.check = config, traffic, \
            cell["check"]
        self.seed, self.steps = seed, steps
        self.dev = resolve_device(device)
        mdl = config["model"]
        if config["pods"] != 1:
            raise ValueError("the card runs one pod of the deployment")
        if config["rms_norm_eps"] != PORT_NORM_EPS:
            raise ValueError(f"the port's RMSNorm epsilon is "
                             f"{PORT_NORM_EPS}, the file's "
                             f"{config['rms_norm_eps']}")
        if (traffic["grad_sync"], traffic["quantize"]) != ("anycost", True):
            raise ValueError("the pod step runs the anycost sync, which "
                             "always quantizes")
        arch = dataclasses.replace(
            get_config(mdl["name"]), sliding_window=config["sliding_window"],
            **{k: mdl[k] for k in ARCH_KEYS})
        self.model = build_model(arch)
        self.family = ref_pod.family(config)
        self.layout = self.family.leaves(mdl)
        self.dtype = arch.param_dtype
        want = {p: (tuple(s), self.dtype) for p, s, _ in self.layout}
        have = {p: (tuple(t.shape), t.dtype)
                for p, t in flatten(self.model.abstract_params()).items()}
        if want != have:
            raise ValueError(f"the program's leaves are not the reference's "
                             f"layout: {sorted(set(have) ^ set(want))} or "
                             f"their shapes differ")
        self.undo = []
        self.tmp = tempfile.mkdtemp(prefix="flbench_pod_")
        cuda = self.dev.type == "cuda"
        dist.init_process_group(
            "nccl" if cuda else "gloo",
            store=dist.FileStore(os.path.join(self.tmp, "store"), 1),
            rank=0, world_size=1,
            **({"device_id": torch.device("cuda", 0)} if cuda else {}))
        self.peers, self.gathers = traffic["peer_pods"], 0
        gather = pdist._all_gather
        pdist._all_gather = self._gather
        self.undo.append(lambda: setattr(pdist, "_all_gather", gather))
        # the port's sync gathers a leaf's payload, scale and mask through
        # the stand-in, or the other pods' rows never reach Eq. 5
        pdist.anycost_sync_leaf(torch.ones(16, device=self.dev),
                                group=dist.group.WORLD)
        if self.gathers != 3:
            raise RuntimeError(f"the port's sync gathered {self.gathers} "
                               f"times through core/distributed."
                               f"_all_gather, not 3 a leaf")
        o = traffic["optimizer"]
        self.opt = adamw(o["lr"], b1=o["b1"], b2=o["b2"], eps=o["eps"],
                         weight_decay=o["weight_decay"], warmup=o["warmup"])
        self.update = self.opt.update
        self.step = steps.make_train_step(
            self.model, Optimizer(self.opt.init, self._update),
            remat=traffic["remat"], grad_sync="anycost",
            keep_frac=traffic["keep_frac"], mesh=pmesh.make_pod_mesh(1))
        self.params = unflatten(lm_inputs.weights(seed, self.layout,
                                                  self.dtype, self.dev))
        self.state = self.opt.init(self.params)
        self.docs = lm_inputs.TokenDocs(seed, traffic, mdl["vocab_size"],
                                        self.dev)
        self.t = 0
        self.rec = None

    def _gather(self, t, group):
        """The sync's gather over the deployment's pods: this pod's ``t``
        and the other pods' rows drawn from it."""
        self.gathers += 1
        return lm_inputs.pod_rows(self.seed, t, self.peers)

    def _update(self, params, grads, state):
        return self.update(params, grads, state)

    def round(self) -> float:
        """One step on step ``t``'s rows; its loss, read on the host as
        ``run_pod`` reads it each step (so a round ends when the card has
        done its work)."""
        batch = {"tokens": self.docs.batch(self.t)}
        self.params, self.state, loss = self.step(self.params, self.state,
                                                  batch)
        self.t += 1
        return float(loss)

    def checked(self) -> None:
        b1 = self.traffic["optimizer"]["b1"]
        losses, rec = [], {}
        for t in range(self.check["steps"]):
            losses.append(self.round())
            if t == 0:
                rec["grad"] = ref_pod.grad_norms(
                    self.layout, flatten(self.state["m"]), b1,
                    self.family.stacked)
        rec["change"] = ref_pod.change_norms(
            self.layout, self.seed, self.dtype, self.dev,
            flatten(self.params), self.family.stacked)
        rec["loss"] = losses
        self.rec = rec

    def timed_hooks(self):
        return None

    @contextlib.contextmanager
    def annotated(self, stacks: list):
        """The step's calls, each in a ``flbench.<phase>``
        ``record_function``, and each Eq. 5 launch's (rows, elements)
        appended to ``stacks``, while the context is open."""
        from repro_torch.kernels import ops

        saved = []
        for phase, name in PHASES.items():
            fn = getattr(self.steps, name)
            saved.append((self.steps, name, fn))
            setattr(self.steps, name, _annotate(phase, fn))
        agg = ops.aio_aggregate_op

        def counted(u, m, w):
            stacks.append((u.shape[0], u[0].numel()))
            return agg(u, m, w)

        saved.append((ops, "aio_aggregate_op", agg))
        ops.aio_aggregate_op = counted
        update = self.update
        self.update = _annotate("optim", update)
        try:
            yield
        finally:
            self.update = update
            for owner, name, fn in saved:
                setattr(owner, name, fn)

    def profiled(self, trace_mod, n_rounds: int) -> dict:
        from repro_torch.kernels import ops

        mdl, tr = self.config["model"], self.traffic
        flops = importlib.import_module(f"roofline.lm_{mdl['family']}")
        stacks = []
        ops.reset_launch_counts()
        with self.annotated(stacks):
            trace = trace_mod.profile_rounds(
                self.round, n_rounds,
                reducers={"device_by_phase": trace_mod.device_by_phase})
        shape = {"flops": n_rounds * 3.0 * flops.forward_flops(
                     mdl, tr["batch"], tr["seq_len"]),
                 "peak": PEAK_OF[mdl["dtype"]], "agg": list(stacks)}
        return {"trace": trace, "shape": shape,
                "launches": dict(ops.launch_counts())}

    def release(self) -> dict:
        rec, self.rec = self.rec, None
        self.params = self.state = self.step = self.docs = None
        return rec

    def close(self) -> None:
        import torch.distributed as dist
        for fn in reversed(self.undo):
            fn()
        self.undo = []
        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(self.tmp, ignore_errors=True)


def _annotate(phase: str, fn):
    def wrapped(*args, **kwargs):
        with torch.profiler.record_function(f"flbench.{phase}"):
            return fn(*args, **kwargs)
    return wrapped


def follow(config: dict, traffic: dict, cell: dict, seed: int, device,
           rec: dict) -> dict:
    """The reference through the checked steps from the seed, and the
    comparison with the program's record."""
    ref = ref_pod.train(config, traffic, seed, device, cell["check"]["steps"])
    return ref_pod.compare(rec, ref)


# ------------------------------------------------------- planted faults
#
# Each breaks the timed path of a built program (``fault(prog)`` of
# ``run.run_cell``); ``PodStep.close`` undoes what it patched.

def _patch(prog, name: str, make):
    fn = getattr(prog.steps, name)
    setattr(prog.steps, name, make(fn))
    prog.undo.append(lambda: setattr(prog.steps, name, fn))


def half_batch(prog) -> None:
    """The loss and gradients of the first half of each batch only."""
    def make(fn):
        def half(model, params, batch, **kw):
            n = batch["tokens"].shape[0] // 2
            return fn(model, params, {k: v[:n] for k, v in batch.items()},
                      **kw)
        return half
    _patch(prog, "value_and_grad", make)


def peers_dropped(prog) -> None:
    """The exchange between pods left out: Eq. 5 over this pod's row
    alone."""
    prog.peers = 0


def sync_skipped(prog) -> None:
    """The whole sync left out: the gradients go to the optimizer as the
    pod computed them."""
    _patch(prog, "anycost_gradient_sync", lambda fn: lambda grads, *a, **k:
           grads)


def lr_doubled(prog) -> None:
    """AdamW at twice the configured rate."""
    from repro_torch.train.optimizer import adamw
    o = prog.traffic["optimizer"]
    prog.update = adamw(2 * o["lr"], b1=o["b1"], b2=o["b2"], eps=o["eps"],
                        weight_decay=o["weight_decay"],
                        warmup=o["warmup"]).update


def zeroed_layer(prog) -> None:
    """The middle layer's gradient of every stacked leaf set to zero."""
    def make(fn):
        def zeroed(model, params, batch, **kw):
            loss, grads = fn(model, params, batch, **kw)
            for path, g in flatten(grads).items():
                if prog.family.stacked(path):
                    g[g.shape[0] // 2].zero_()
            return loss, grads
        return zeroed
    _patch(prog, "value_and_grad", make)


def frozen(prog) -> None:
    """A step that hands its state back unchanged."""
    prog.update = lambda params, grads, state: (params, state)


FAULTS = {"half_batch": half_batch, "peers_dropped": peers_dropped,
          "sync_skipped": sync_skipped, "lr_doubled": lr_doubled,
          "zeroed_layer": zeroed_layer, "frozen": frozen}


def control(config: dict, traffic: dict, cell: dict, seed: int, device
            ) -> dict:
    """The reference in float8 products put in the program's place: its
    record of the checked steps."""
    return ref_pod.train(config, traffic, seed, device,
                         cell["check"]["steps"], mode="fp8")


def fault(name: str, config: dict, traffic: dict, cell: dict, seed: int,
          device) -> dict:
    """The program's record of the checked steps with :data:`FAULTS`'
    ``name`` planted."""
    prog = build(config, traffic, cell, seed, device)
    try:
        FAULTS[name](prog)
        prog.checked()
        return prog.release()
    finally:
        prog.close()
