"""The system under test: the port's round loop, built from a cell's files.

:func:`build` makes ``orchestrator.runner.Simulation`` and the policy as
``runner.run_orchestrated`` makes them; :meth:`Program.round` drives
``runner._run_round_based``, the loop ``run_orchestrated`` dispatches the
round-based policies to, for one round, and carries the round's
``History.final_params`` into ``Simulation.params``.  Every round ends
with the test-set evaluation (``eval_every=1``).

:class:`Hooks` wraps the calls the round loop makes into each layer
(``Simulation`` methods, the pool's ``train_shared``, the hierarchical
merge), for two uses: recording what the comparison reads in the checked
rounds, and timing each phase in a traced run.  A wrapper only observes:
it hands every argument through and returns the call's own result.
"""
from __future__ import annotations

import contextlib
import time
from typing import Callable, Optional

import torch

#: phase -> the wrapped calls whose time it sums
PHASES = {"prepare": ("sort_params", "gate_round", "prepare"),
          "train": ("train_shared", "train_one"),
          "materialize": ("materialize",),
          "aggregate": ("aggregate", "_hier_round_merge"),
          "eval": ("evaluate",)}
_PHASE_OF = {call: ph for ph, calls in PHASES.items() for call in calls}


def build(config: dict, traffic: dict, seed: int, uniforms, device):
    """(sim, policy, orch) for one cell, as ``run_orchestrated`` builds
    them."""
    from repro_torch.configs import get_config
    from repro_torch.orchestrator import runner
    from repro_torch.orchestrator.policies import (OrchestratorConfig,
                                                   make_policy)
    from repro_torch.sysmodel.population import FleetConfig
    from repro_torch.sysmodel.wireless import WirelessConfig
    from repro_torch.topology.cells import TopologyConfig
    from repro_torch.train.fl_loop import FLRunConfig

    mdl, data, fl = config["model"], config["data"], config["fleet"]
    arch = get_config(mdl["name"])
    for key in ("d_model", "d_ff", "n_layers", "vocab_size"):
        if getattr(arch, key) != mdl[key]:
            raise ValueError(f"{mdl['name']}: the program's {key} is "
                             f"{getattr(arch, key)}, the file's {mdl[key]}")
    run_cfg = FLRunConfig(
        arch=mdl["name"], method=traffic["method"], rounds=1,
        lr=traffic["lr"], batch_size=traffic["batch_size"],
        tau=traffic["tau"], seed=seed, iid=traffic["iid"],
        n_train=data["n_train"], n_test=data["n_test"], eval_every=1,
        use_planner=traffic["planner"])
    topo = None
    if traffic["cells"] > 1:
        topo = TopologyConfig(kind="hier", n_cells=traffic["cells"])
    fleet_cfg = FleetConfig(
        n_devices=fl["n_devices"], T_max=fl["T_max"],
        E_max_range=tuple(fl["E_max_range"]),
        eps_range=tuple(fl["eps_range"]), f_min=fl["f_min"],
        f_max=fl["f_max"], tau=fl["tau"], alpha_min=fl["alpha_min"],
        beta_min=fl["beta_min"], beta_max=fl["beta_max"],
        wireless=WirelessConfig(**fl["wireless"]), topology=topo)
    orch = OrchestratorConfig(policy=traffic["policy"],
                              use_pool=traffic["use_pool"])
    sim = runner.Simulation(run_cfg, fleet_cfg, device=device,
                            uniforms=uniforms)
    sim.agg_route = sim.resolve_agg_route(orch.agg_route)
    policy = make_policy(orch, fleet_T_max=sim.fleet_cfg.T_max)
    if not policy.round_based:
        raise ValueError("the benchmark drives the round-based loop")
    return sim, policy, orch


class Program:
    def __init__(self, sim, policy, orch):
        from repro_torch.orchestrator import runner
        self.runner = runner
        self.sim, self.policy, self.orch = sim, policy, orch

    def round(self) -> None:
        hist = self.runner._run_round_based(self.sim, self.policy,
                                            self.orch, False)
        self.sim.params = hist.final_params


class Hooks:
    """Wrappers around the round loop's calls into each layer.

    ``observe(name, args, result)`` sees each wrapped call once it
    returns; with ``timed`` every call also lands in ``spans`` as
    seconds per phase, between two ``torch.cuda.synchronize()``; with
    ``annotate`` each call runs inside a ``torch.profiler``
    ``record_function`` named ``flbench.<phase>``."""

    def __init__(self, prog: Program, *, observe: Optional[Callable] = None,
                 timed: bool = False, annotate: bool = False):
        self.prog = prog
        self.observe = observe
        self.timed = timed
        self.annotate = annotate
        self.spans: dict[str, float] = {}
        self._saved = []

    def _wrap(self, owner, name: str) -> None:
        fn = getattr(owner, name)
        phase = _PHASE_OF[name]
        hooks = self
        sync = torch.cuda.synchronize if torch.cuda.is_available() \
            else (lambda: None)

        def wrapped(*args, **kwargs):
            ctx = torch.profiler.record_function(f"flbench.{phase}") \
                if hooks.annotate else contextlib.nullcontext()
            if hooks.timed:
                sync()
                t0 = time.perf_counter()
            with ctx:
                out = fn(*args, **kwargs)
            if hooks.timed:
                sync()
                hooks.spans[phase] = hooks.spans.get(phase, 0.0) \
                    + time.perf_counter() - t0
            if hooks.observe is not None:
                hooks.observe(name, args, kwargs, out)
            return out

        self._saved.append((owner, name, owner.__dict__.get(name)))
        setattr(owner, name, wrapped)

    def __enter__(self):
        sim = self.prog.sim
        for name in ("sort_params", "gate_round", "prepare", "train_one",
                     "materialize", "aggregate", "evaluate", "encode_ship"):
            if name == "encode_ship":
                if self.observe is not None:
                    self._wrap_plain(sim, name)
                continue
            self._wrap(sim, name)
        self._wrap(sim.pool, "train_shared")
        self._wrap(self.prog.runner, "_hier_round_merge")
        return self

    def _wrap_plain(self, owner, name: str) -> None:
        fn = getattr(owner, name)
        hooks = self

        def wrapped(*args, **kwargs):
            hooks.observe(name, args, kwargs, None)
            return fn(*args, **kwargs)

        self._saved.append((owner, name, owner.__dict__.get(name)))
        setattr(owner, name, wrapped)

    def __exit__(self, *exc):
        for owner, name, old in reversed(self._saved):
            if old is None:
                delattr(owner, name)
            else:
                setattr(owner, name, old)
        self._saved = []
        return False

    def take_spans(self) -> dict[str, float]:
        out, self.spans = self.spans, {}
        return out
