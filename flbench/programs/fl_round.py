"""The federated round: the port's round loop (``bench/program.py``),
checked round by round against ``reference/fl.py``.

Set-up drives the cell's checked rounds through the loop with
``program.Hooks`` and ``check.StepTap`` recording what the comparison
reads (``bench/check.py``); a traced window times each phase with the
hooks' synchronize-bracketed wrappers, and the profiled rounds run each
phase inside a ``record_function``.

:func:`control` and :func:`fault` give the upper readings of the
comparison's limits (``readings.py``): the reference in TF32, or with
one of its planted faults (:data:`FAULTS`), put in the program's place.
"""
from __future__ import annotations

from bench import check, inputs, program
from reference import fl as ref_fl, model as ref_model


def build(config: dict, traffic: dict, cell: dict, seed: int, device):
    uniforms = inputs.SeededUniforms(seed, device)
    return FLRound(config, traffic, cell, seed,
                   *program.build(config, traffic, seed, uniforms, device))


class FLRound(program.Program):
    def __init__(self, config, traffic, cell, seed, sim, policy, orch):
        super().__init__(sim, policy, orch)
        self.config, self.traffic, self.check = config, traffic, \
            cell["check"]
        self.seed = seed
        self.cap = check.Capture()

    def checked(self) -> None:
        chk, cap = self.check, self.cap
        sample = inputs.sample_devices(self.seed,
                                       self.config["fleet"]["n_devices"],
                                       chk["sample"])
        numels = [x.numel() for x in ref_model.leaves(self.sim.params)]
        rec = check.ProgramRecorder(cap, sample, numels)
        with program.Hooks(self, observe=rec), \
                check.StepTap(self, cap, self.seed, chk["per_width"]) as tap:
            for t in range(chk["rounds"]):
                rec.t = tap.t = t
                self.round()

    def timed_hooks(self):
        return program.Hooks(self, timed=True)

    def profiled(self, trace_mod, n_rounds: int) -> dict:
        """``n_rounds`` more rounds under the profiler, each phase in a
        ``record_function``; the reduced trace, the launches and the
        shapes the roofline and the MFU read."""
        from repro_torch.kernels import ops

        mdl, data = self.config["model"], self.config["data"]
        batch = self.traffic["batch_size"]
        leaves = ref_model.leaves(self.sim.params)
        n = sum(x.numel() for x in leaves)
        shape = {"N": n, "agg": [], "folds": 0, "flops": 0.0,
                 "peak": "f32_flops_per_s"}
        shape["K"] = sum(x.shape[-1] if x.dim() >= 2 else 1 for x in leaves)

        def observe(name, args, kwargs, out):
            if name == "prepare" and out is not None:
                shape["flops"] += 3.0 * ref_model.forward_flops(
                    mdl, out.alpha, out.n_steps * batch)
            elif name == "aggregate":
                shape["agg"].append((len(args[1]), n))
            elif name == "encode_ship":         # one edge's fold shipped
                shape["folds"] += 1
            elif name == "evaluate":
                shape["flops"] += ref_model.forward_flops(mdl, 1.0,
                                                          data["n_test"])

        ops.reset_launch_counts()
        with program.Hooks(self, observe=observe, annotate=True):
            tr = trace_mod.profile_rounds(self.round, n_rounds)
        return {"trace": tr, "launches": dict(ops.launch_counts()),
                "shape": shape}

    def release(self) -> check.Capture:
        cap, self.cap = self.cap, None
        self.sim = self.policy = self.orch = None
        return cap


def follow(config: dict, traffic: dict, cell: dict, seed: int, device,
           cap: check.Capture) -> dict:
    return ref_fl.follow(config, traffic, seed,
                         inputs.SeededUniforms(seed, device), device, cap,
                         cell["check"]["rounds"])


#: the faults ``reference/fl.simulate`` plants in its rounds
FAULTS = ("frozen", "half_batch", "altered")


def _stand_in(config, traffic, cell, seed, device, **kw) -> check.Capture:
    chk = cell["check"]
    sample = inputs.sample_devices(seed, config["fleet"]["n_devices"],
                                   chk["sample"])
    cap = check.Capture()
    ref_fl.simulate(config, traffic, seed,
                    inputs.SeededUniforms(seed, device), device,
                    chk["rounds"], cap, sample=sample,
                    per_width=chk["per_width"], **kw)
    return cap


def control(config: dict, traffic: dict, cell: dict, seed: int, device
            ) -> check.Capture:
    """The reference in TF32 put in the program's place: its capture of
    the checked rounds."""
    return _stand_in(config, traffic, cell, seed, device, mode="tf32")


def fault(name: str, config: dict, traffic: dict, cell: dict, seed: int,
          device) -> check.Capture:
    """The reference with the fault ``name`` (:data:`FAULTS`) planted, in
    the program's place."""
    if name not in FAULTS:
        raise KeyError(name)
    return _stand_in(config, traffic, cell, seed, device, fault=name)
