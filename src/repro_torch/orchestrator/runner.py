"""FL runner over the discrete-event engine: the ``sync``, ``semisync``
and ``fedbuff`` policies on a flat or hierarchical fleet, static or
dynamic, fixed or moving, for every method of ``train/fl_loop.METHODS``.

``run_orchestrated`` builds a :class:`Simulation` and the policy
(``policies.make_policy``).  ``anycostfl`` solves Problem (P4) per
device and compresses with FGC; ``use_ems``, ``use_fgc`` and ``use_aio``
switch off one component each (Fig. 5a).  The baselines (``stc``,
``qsgd``, ``uveqfed``, ``heterofl``, ``fedhq``, ``fedavg``) take their
strategy and compressor from ``train/baselines.BaselinePolicy`` and
never sit a round out; the weights follow the method
(``policies.base_weights``).

Timeline semantics:

* **sync / semisync** (round-based, :func:`_run_round_based`): every
  device is dispatched at the round start and arrives ``T_cmp + T_com``
  later (Eq. 6-9, the realized strategy); the policy decides the round
  barrier and which arrivals aggregate.  With the client pool on (the
  default under semisync) the round's devices train in one vmapped call
  per width bucket (``orchestrator/client_pool.py``).
* **fedbuff** (stream-based, :func:`_run_fedbuff`): devices run free;
  each arrival enters the server buffer with staleness = (server version
  now) - (version at dispatch) and the device re-dispatches at once on a
  fresh channel draw.  Every ``K`` arrivals the server merges with the
  AIO rule under staleness-discounted unnormalized weights, streaming
  each update into one ``(num, den)`` accumulator (``aio_absorb`` once
  per update) and never stacking the buffer.  Local training is
  deferred to the merge, so the buffer trains as one batch
  (``ClientPool.train_stacked``); the event times use each device's
  *planned* wire size, the energy and bits its realized ones.  EMS
  channel sorting is frozen at t=0: cross-version element-wise merges
  need one coordinate frame.  ``--max-inflight`` caps the dispatched
  flights; waiters join a FIFO.

**Hierarchical topologies** (``FleetConfig.topology`` of kind ``hier``,
round-based policies only): devices are partitioned into cells, each
with its own wireless environment; each cell's edge applies the arrival
policy to its own arrivals, folds the accepted updates into one O(N)
streaming partial with *unnormalized* coefficients (``aio_absorb``, in
place), and ships it over the modelled backhaul, through the wire codec;
the cloud merges the partials (EDGE_MERGE events, ``aio_merge`` in
place) and finalizes Eq. 5 once (:func:`_hier_round_merge`).
``OrchestratorConfig.agg_route`` ``batched`` aggregates the same
accepted updates with the flat Eq. 5 (``aio_aggregate``) instead,
charging the same backhaul costs.

**Fleet dynamics** (``FleetConfig.dynamics``): at each round start only
the devices the availability trace has in the cell and whose battery
holds ``min_headroom_j`` are candidates; their energy budget is clamped
to the battery's headroom, and the selection policy picks the round's
cohort under the participation cap (per cell on a hierarchy).  A device
whose trace says it leaves before its planned ``T_cmp + T_com`` elapses
is prepared (its minibatches and uniforms drawn) but never trained: it
aborts with a CHURN event and is charged its planned energy pro rata.
Under fedbuff a flight ends in COMPLETE or CHURN, and a gated device
RETRYs when its trace turns on or its battery is ready again.

**Mobility** (``FleetConfig.mobility``): positions follow seeded
trajectories and Eq. 8 sees the distance to the serving site; at each
round boundary the handover engine re-homes devices (one HANDOVER event
a move) before dispatch, and a flight merges at the cell recorded at
its dispatch.  A replay scenario can also step each cell's backhaul rate
over time (``Simulation.cell_backhaul``).

**Telemetry** (``telemetry=``, a ``repro_torch.telemetry.Telemetry``):
the run's ``MetricsRegistry`` is always live, as the store behind every
``RoundLog`` and the ``dispatch.latency_s`` observations; spans,
instants, cost counters, the ``learning.*`` diagnostics
(``telemetry/learning.LearningRecorder``, imported only when a session
is on) and the health engine run behind ``if tel.enabled`` guards.  They
draw from no random stream, write into no tensor the run reads, and
launch no kernel, so a run gives the same result bit for bit with a
session or without one.

The numpy generator is consumed in the reference's order
(``repro/orchestrator/runner.py``): setup (task data, partition,
fleet), then per round (per dispatch under fedbuff) the channel draws,
the planner's probe permutation (first round only) and each device's
minibatch draws, so one seed gives the reference's data, fleet,
channels, strategies and event timeline.

Randomness the reference draws from its JAX key chain (the planner's
probe quantization and each device's quantization uniforms) comes from
an injectable *uniform source* instead, split at the same two places
the reference splits its key.  By default it is a ``torch.Generator`` on
the run's device; tests hand in a source that replays the reference's
key chain.
"""
from __future__ import annotations

import dataclasses
import math
from collections import deque
from typing import Any, Callable, Optional, Protocol

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import aggregation, compression, schedule, shrinking
from repro_torch.core.anycost import (AnycostClient, AnycostServer,
                                      ClientUpdate, bucket_alpha)
from repro_torch.data.partition import partition_dirichlet, partition_iid
from repro_torch.data.synthetic import make_image_task
from repro_torch.device import resolve_device
from repro_torch.fleet import AlwaysOn, FleetDynamicsConfig, make_selection
from repro_torch.mobility import HandoverEngine
from repro_torch.models import cnn as cnn_mod
from repro_torch.models.registry import build_model
from repro_torch.orchestrator import events as ev_mod
from repro_torch.orchestrator.client_pool import ClientPool, TrainJob
from repro_torch.orchestrator.policies import (STALE_REQUEUE,
                                               OrchestratorConfig,
                                               apply_scales, base_weights,
                                               make_policy, staleness_scales,
                                               unnormalized_weight)
from repro_torch.sysmodel.population import FleetConfig, make_fleet
from repro_torch.telemetry import (NULL_TELEMETRY, MetricsRegistry,
                                   profile_trace)
from repro_torch.topology.codec import (decode_partial, encode_partial,
                                        payload_bits)
from repro_torch.topology.edge import (CodecErrorFeedback, EdgeAggregator,
                                       cloud_merge, finalize_apply)
from repro_torch.train.baselines import BaselinePolicy
from repro_torch.train.fl_loop import (METHODS, FLRunConfig, History,
                                       _device_batches, _make_eval,
                                       flops_per_sample)
from repro_torch.utils.pytree import (tree_leaves, tree_map, tree_size,
                                      tree_sub)

PyTree = Any
#: n -> (n,) float32 uniforms in [0, 1) on the run's device; a draw
#: gives the same numbers each time it is called with the same n, as a
#: JAX key does (fedbuff's requeue retrains with the rejected flight's)
Draw = Callable[[int], torch.Tensor]


class UniformSource(Protocol):
    """Where the run's quantization uniforms come from."""

    def planner_stream(self) -> Draw:
        """The planner's probe draw (the reference's one 2-way key split)."""

    def device_stream(self) -> Draw:
        """One prepared device's draw (the reference's 3-way key split)."""


class TorchUniforms:
    """The default uniform source: a seeded ``torch.Generator`` on the
    run's device hands each split a child seed of its own."""

    def __init__(self, seed: int, device):
        self.device = torch.device(device)
        self._gen = torch.Generator(device=self.device).manual_seed(seed)

    def _child(self) -> Draw:
        seed = int(torch.randint(0, 2 ** 62, (1,), generator=self._gen,
                                 device=self.device))
        dev = self.device
        return lambda n: torch.rand(
            n, generator=torch.Generator(device=dev).manual_seed(seed),
            device=dev)

    def planner_stream(self) -> Draw:
        return self._child()

    def device_stream(self) -> Draw:
        return self._child()


@dataclasses.dataclass
class PendingUpdate:
    """A dispatched client round travelling through the event queue."""
    client_id: int
    env: schedule.DeviceEnv
    strat: schedule.Strategy
    alpha: float                 # bucketed width actually trained
    batches: dict
    draw: Draw                   # the round's quantization uniforms
    n_steps: int
    version: int = 0             # server version at dispatch (fedbuff)
    cell: int = 0                # serving cell at dispatch: the update
                                 # merges at the edge that dispatched it
    dispatched_at: float = 0.0
    completes_at: float = 0.0
    staleness: int = 0
    # filled by Simulation.materialize
    update: Optional[ClientUpdate] = None
    fedhq_level: Optional[int] = None
    t_cmp: float = 0.0
    t_com: float = 0.0
    energy: float = 0.0
    e_cmp: float = 0.0           # compute (train) share of energy
    e_com: float = 0.0           # radio (uplink) share of energy

    @property
    def duration(self) -> float:
        return self.t_cmp + self.t_com


class Simulation:
    """Shared state + the per-device round body."""

    def __init__(self, run_cfg: FLRunConfig,
                 fleet_cfg: Optional[FleetConfig] = None, *,
                 device="cuda", uniforms: Optional[UniformSource] = None,
                 telemetry=None):
        if run_cfg.method not in METHODS:
            raise ValueError(f"unknown method {run_cfg.method!r}; expected "
                             f"one of {METHODS}")
        self.device = resolve_device(device)
        self.run_cfg = run_cfg
        # telemetry: the registry is ALWAYS live (it is RoundLog's backing
        # store: host-side dicts that touch no RNG stream and no tensor);
        # the trace sink and the per-device emission run only behind
        # ``if self.tel.enabled`` guards
        self.tel = telemetry if telemetry is not None \
            and telemetry.enabled else NULL_TELEMETRY
        self.registry = self.tel.registry if self.tel.enabled \
            else MetricsRegistry()
        # setup order mirrors the reference: the numpy stream position
        # after setup must match it
        rng = self.rng = np.random.default_rng(run_cfg.seed)
        arch_cfg = self.arch_cfg = get_config(run_cfg.arch)
        self.model = build_model(arch_cfg)
        self.spec = shrinking.cnn_shrink_spec(arch_cfg)
        self.train, self.test = make_image_task(
            rng, run_cfg.n_train, run_cfg.n_test,
            shape=cnn_mod.image_shape(arch_cfg))
        test_x = torch.from_numpy(self.test.x).to(self.device)
        test_y = torch.from_numpy(self.test.y).to(self.device)
        fleet_cfg = self.fleet_cfg = fleet_cfg or FleetConfig()
        # engages the registry's rollup policy (if one was configured)
        # past its threshold; records nothing, so no guard is needed
        self.registry.set_fleet_size(fleet_cfg.n_devices)
        if run_cfg.iid:
            self.parts = partition_iid(rng, run_cfg.n_train,
                                       fleet_cfg.n_devices)
        else:
            self.parts = partition_dirichlet(rng, self.train.y,
                                             fleet_cfg.n_devices,
                                             run_cfg.dirichlet_alpha)
        self.fleet = make_fleet(
            rng, fleet_cfg, np.array([len(p) for p in self.parts]))
        self.W = flops_per_sample(arch_cfg)
        self.params = self.model.init(
            torch.Generator().manual_seed(run_cfg.seed), self.device)
        self._n_params = tree_size(self.params)
        self.S_bits = 32.0 * self._n_params
        self.client = AnycostClient(self.model, self.spec, lr=run_cfg.lr,
                                    batch_size=run_cfg.batch_size,
                                    alpha_buckets=run_cfg.alpha_buckets)
        self.server = AnycostServer(self.model, self.spec)
        self.baseline = None
        if run_cfg.method != "anycostfl":
            self.baseline = BaselinePolicy(run_cfg.method)
        # HeteroFL's width tier per device: compute-capability terciles
        self.tiers = np.argsort(np.argsort(-self.fleet.eps_hw)) * 3 \
            // fleet_cfg.n_devices
        self.planner = None
        self.ev = _make_eval(self.model, test_x, test_y)
        self.uniforms = uniforms if uniforms is not None \
            else TorchUniforms(run_cfg.seed + 1, self.device)
        self.pool = ClientPool(self.client)

        # fleet-dynamics control plane: selection draws from a generator
        # of its own, so who trains when never moves the model-init, data
        # or channel streams
        dyn = self.dyn = fleet_cfg.dynamics or FleetDynamicsConfig()
        sel_seed = dyn.selection_seed if dyn.selection_seed is not None \
            else run_cfg.seed
        self.selection = make_selection(
            dyn.selection, np.random.default_rng([0x5E1EC7, sel_seed]))
        # (t, client_id, headroom_j) per successful dispatch
        self.dispatch_log: list[tuple] = []
        self.fleet_dynamic = (
            (self.fleet.trace is not None
             and not isinstance(self.fleet.trace, AlwaysOn))
            or self.fleet.battery is not None)

        # hierarchical topology (None -> the paper's flat single cell)
        topo = fleet_cfg.topology
        self.topo = topo if topo is not None and topo.kind == "hier" \
            else None
        # mobility: the handover engine re-homes devices at round
        # boundaries; a replay scenario may step each cell's backhaul
        self.handover = None
        if self.topo is not None and self.fleet.mobility is not None \
                and self.topo.handover is not None \
                and self.fleet.n_cells > 1:
            self.handover = HandoverEngine(self.topo.handover,
                                           self.fleet.sites)
        self.cell_backhauls = self.topo.cell_backhauls() \
            if self.topo is not None else None
        self.scenario = self.fleet.scenario
        self.codec_ef = None
        self._ef_frame = None
        if self.topo is not None and self.topo.backhaul.error_feedback:
            self.codec_ef = CodecErrorFeedback()
        # set from OrchestratorConfig.agg_route by run_orchestrated
        self.agg_route = "streaming"

        # learning diagnostics: only an enabled session gets a recorder,
        # and the import is deferred to that branch, so a run without
        # telemetry never loads the module
        self.learn = None
        if self.tel.enabled:
            from repro_torch.telemetry.learning import LearningRecorder
            self.learn = LearningRecorder(self.spec,
                                          self.fleet_cfg.n_devices)

    # ------------------------------------------------------- fleet dynamics

    def effective_T_max(self, t_wall: float) -> float:
        """Battery-aware deadline: while the fleet's mean state of charge
        is below ``soc_deadline_threshold``, the T_max handed to the
        Problem-(P4) solver shrinks by ``soc_deadline_scale``; the
        fleet's T_max when unconfigured or without a battery."""
        scale = self.dyn.soc_deadline_scale
        if scale is None or self.fleet.battery is None:
            return self.fleet_cfg.T_max
        if self.fleet.battery.mean_soc_frac(t_wall) \
                < self.dyn.soc_deadline_threshold:
            return self.fleet_cfg.T_max * scale
        return self.fleet_cfg.T_max

    def gate_round(self, t_wall: float, envs: list[schedule.DeviceEnv]):
        """Availability, battery and selection gating of a round-based
        dispatch.  Returns ``(selected, envs_eff, n_unavailable,
        headroom)``.

        On a static fleet (always on, no battery, uniform selection with
        no binding cap) it selects every device in order, consumes no
        randomness and hands back the caller's env objects."""
        n = self.fleet_cfg.n_devices
        cand = [i for i in range(n) if self.fleet.available(i, t_wall)]
        envs_eff = {i: self.fleet.dynamic_env(i, envs[i], t_wall)
                    for i in cand}
        t_max_eff = self.effective_T_max(t_wall)
        if t_max_eff != self.fleet_cfg.T_max:
            envs_eff = {i: dataclasses.replace(e, T_max=t_max_eff)
                        for i, e in envs_eff.items()}
        headroom = {i: (self.fleet.battery.headroom(i, t_wall)
                        if self.fleet.battery is not None
                        else envs_eff[i].E_max) for i in cand}
        if not cand:
            return [], envs_eff, n, headroom
        if self.topo is not None and self.fleet.n_cells > 1:
            # per-cell selection: each edge runs the policy over its own
            # roster under its own cap, in ascending cell order
            selected = []
            for k in range(self.fleet.n_cells):
                ck = [i for i in cand if self.fleet.cell_of(i) == k]
                if not ck:
                    continue
                selected.extend(self.selection.select(
                    ck, envs_eff, headroom, self._cap(len(ck))))
            return sorted(selected), envs_eff, n - len(cand), headroom
        selected = self.selection.select(cand, envs_eff, headroom,
                                         self._cap(len(cand)))
        return selected, envs_eff, n - len(cand), headroom

    def _cap(self, n_cand: int) -> int:
        """The participation cap over ``n_cand`` candidates."""
        if self.dyn.participation >= 1.0:
            return n_cand
        return max(1, math.ceil(self.dyn.participation * n_cand))

    def mean_soc(self, t: float) -> float:
        """The fleet's mean state of charge at ``t`` (1.0 without a
        battery)."""
        if self.fleet.battery is None:
            return 1.0
        return self.fleet.battery.mean_soc_frac(t)

    # ------------------------------------------------------------ round body

    def sort_params(self, params: PyTree) -> PyTree:
        if not self.run_cfg.use_ems:
            return shrinking._deepcopy_dicts(params)
        if self.codec_ef is None:
            return self.server.sort(params)
        # EF residuals live in the sorted coordinate frame: keep the
        # round's sort permutations, so that a frame move drops a stale
        # residual instead of adding it into the wrong channels
        sorted_p, perms = shrinking.sort_channels(params, self.spec,
                                                  return_perms=True)
        self._ef_frame = tuple(tuple(p.tolist()) for p in perms)
        return sorted_p

    def ensure_planner(self, sorted_params: PyTree) -> None:
        """Fit the server-side beta planner on a probe update (§III-C.3):
        AnycostFL only, and with ``use_fgc=False`` too, as in the
        reference, so the numpy stream and the uniform source advance
        alike."""
        rc = self.run_cfg
        if self.planner is None and rc.method == "anycostfl" \
                and rc.use_planner:
            draw = self.uniforms.planner_stream()
            probe_idx = self.rng.permutation(rc.n_train)[:16]
            probe_batches = {
                "images": torch.from_numpy(
                    self.train.x[probe_idx][None]).to(self.device),
                "labels": torch.from_numpy(
                    self.train.y[probe_idx][None]).to(self.device)}
            trained = self.client._local_steps(sorted_params, probe_batches)
            probe_update = tree_sub(sorted_params, trained)
            self.planner = compression.BetaPlanner.fit(
                probe_update, draw(self._n_params))

    def prepare(self, i: int, env: schedule.DeviceEnv
                ) -> Optional[PendingUpdate]:
        """Strategy + minibatch draw for device i (consumes the streams in
        the reference's order). Returns None when no (alpha, beta, f)
        satisfies the budgets (the device sits this round out); a
        baseline always runs, at its realized cost."""
        rc = self.run_cfg
        if self.baseline is None:
            strat = schedule.solve(env)
            if not strat.feasible:
                return None
            if not rc.use_ems:
                strat = dataclasses.replace(strat, alpha=1.0)
            if not rc.use_fgc:
                strat = dataclasses.replace(strat, beta=1.0)
            alpha = bucket_alpha(strat.alpha, rc.alpha_buckets)
        else:
            strat = self.baseline.strategy(env, tier=int(self.tiers[i]))
            alpha = bucket_alpha(strat.alpha, rc.alpha_buckets) \
                if rc.method == "heterofl" else 1.0
        draw = self.uniforms.device_stream()
        batches = _device_batches(self.rng, self.train.x, self.train.y,
                                  self.parts[i], rc.batch_size, rc.tau,
                                  self.device)
        return PendingUpdate(client_id=i, env=env, strat=strat, alpha=alpha,
                             batches=batches, draw=draw,
                             n_steps=int(batches["images"].shape[0]),
                             cell=self.fleet.cell_of(i))

    def train_one(self, p: PendingUpdate, sorted_params: PyTree) -> PyTree:
        sub = shrinking.shrink(sorted_params, p.alpha, self.spec)
        return self.client._local_steps(sub, p.batches)

    def materialize(self, p: PendingUpdate, trained: PyTree,
                    sorted_params: PyTree, *,
                    sub: Optional[PyTree] = None) -> PendingUpdate:
        """Decode the trained sub-model into a ClientUpdate + realized costs
        (Eq. 6-9), with the reference's float-op order.  ``sub`` is the
        shrunk model the device trained from, when the caller has it (the
        client pool's); otherwise it is shrunk here."""
        rc = self.run_cfg
        env, strat = p.env, p.strat
        if sub is None:
            sub = shrinking.shrink(sorted_params, p.alpha, self.spec)
        if self.baseline is None:
            rand = p.draw(self._n_params)
            planner = self.planner if rc.use_fgc else None
            upd = self.client.finish_round(
                sorted_params, p.alpha, trained, strat, p.n_steps, rand,
                planner=planner, w_per_sample=self.W, sub=sub)
            if not rc.use_fgc:
                # transmit the raw (width-masked) update
                upd = dataclasses.replace(
                    upd, bits=32.0 * strat.alpha * self._n_params,
                    beta_realized=1.0)
        else:
            full_update, wmask = shrinking.expand_update(
                tree_sub(sub, trained), sorted_params, p.alpha, self.spec)
            comp = self.baseline.compress(full_update, env, p.draw)
            mask = tree_map(lambda a, b: a * b, wmask, comp.mask)
            vals = tree_map(lambda v, m: v * m, comp.values, mask)
            n_samp = p.n_steps * rc.batch_size
            bits = float(comp.bits)
            upd = ClientUpdate(
                values=vals, mask=mask, alpha=p.alpha,
                beta_target=strat.beta, beta_realized=bits / self.S_bits,
                bits=bits, n_samples=n_samp,
                flops=p.alpha * self.W * n_samp)
            if rc.method == "fedhq":
                p.fedhq_level = self.baseline.fedhq_levels(env)
        p.update = upd
        # realized costs (Eq. 6-9) with the *realized* wire size
        t_com = upd.bits / env.rate
        e_com = t_com * env.P_com
        t_cmp = upd.alpha * env.tau * env.D * env.W / strat.freq
        e_cmp = env.eps_hw * strat.freq ** 2 * upd.alpha \
            * env.tau * env.D * env.W
        p.t_com, p.t_cmp = t_com, t_cmp
        p.e_cmp, p.e_com = e_cmp, e_com
        p.energy = e_cmp + e_com
        return p

    def aggregate(self, sorted_params: PyTree, accepted: list[PendingUpdate],
                  weights: torch.Tensor) -> PyTree:
        """Eq. 5 and the server step."""
        return self.server.aggregate(sorted_params,
                                     [p.update for p in accepted],
                                     weights=weights)

    def evaluate(self, params: PyTree) -> tuple[float, float]:
        acc, loss = self.ev(params)
        return float(acc), float(loss)

    # --------------------------------------------------- hierarchical glue

    def cell_backhaul(self, k: int, t_wall: float):
        """Cell k's backhaul at time t: its (possibly heterogeneous)
        draw, with the rate the scenario trace gives the cell at t, if
        it gives one."""
        bh = self.cell_backhauls[k]
        if self.scenario is not None:
            rate = self.scenario.backhaul_rate(k, t_wall)
            if rate is not None:
                bh = dataclasses.replace(bh, rate_bps=rate)
        return bh

    def encode_ship(self, k: int, part: aggregation.PartialAgg):
        """Wire-encode cell k's partial, through the cell's EF residual
        when the codec runs with error feedback."""
        codec = self.topo.backhaul.codec
        if self.codec_ef is not None:
            return self.codec_ef.encode_ship(k, part, codec,
                                             frame=self._ef_frame)
        return encode_partial(part, codec)

    def resolve_agg_route(self, route: str) -> str:
        """The batched route aggregates in exact float32: only the
        streaming edge fold passes the numerics through the wire codec
        (the bits are charged at the codec's size on both)."""
        if route != "streaming" and self.topo is not None \
                and (self.topo.backhaul.codec != "f32"
                     or self.codec_ef is not None):
            print(f"[topology] warning: --agg-route {route} models the "
                  f"backhaul codec's cost but not its numerics (and "
                  f"ignores --backhaul-ef); use the streaming route to "
                  f"study codec/EF effects")
        return route


# ---------------------------------------------------------------- round mode

def _hier_round_merge(sim: Simulation, policy,
                      live: list[PendingUpdate],
                      aborted: list[PendingUpdate], sorted_params: PyTree,
                      queue: ev_mod.EventQueue, t_wall: float,
                      round_idx: int = 0):
    """One hierarchical round tail: per-cell accept -> edge absorb ->
    backhaul ship -> cloud merge.

    Each cell applies the arrival policy to its own arrivals (trimmed to
    ``cell_deadline_s`` when set), folds the accepted updates into its
    partial with unnormalized coefficients, and ships it; the round
    lasts until the slowest cell's barrier plus its shipping time.  A
    cell with an aborted flight learns of it at the departure, but never
    waits past its barrier.  Membership is the cell recorded on each
    flight at dispatch (``PendingUpdate.cell``): handover re-homes
    devices between rounds, never an update already in the air.  Each
    cell ships over its backhaul at ``t_wall``
    (:meth:`Simulation.cell_backhaul`).

    Returns ``(accepted, new_params or None, lat, ship_energy,
    backhaul_bits, n_cells_reporting, lat_parts)``; ``lat_parts`` splits
    ``lat`` into (train, uplink, backhaul) along the critical cell."""
    topo, fleet, rc = sim.topo, sim.fleet, sim.run_cfg
    tel = sim.tel
    cell_dl = topo.cell_deadline_s
    route = sim.agg_route
    accepted_all, parts, ships, route_pairs = [], [], [], []
    lat = e_ship = bh_bits = 0.0
    n_rep = 0
    # (total, barrier, ship, max accepted t_cmp) per cell: the critical
    # path of the round's latency split
    crit: list[tuple[float, float, float, float]] = []
    for k in range(fleet.n_cells):
        cell_live = [p for p in live if p.cell == k]
        cell_ab = [p for p in aborted if p.cell == k]
        if not cell_live and not cell_ab:
            continue
        acc_k, scales_k, lat_k = policy.accept(cell_live, 0.0)
        if cell_dl is not None:
            # the edge never waits past its own deadline
            pairs = [(p, s) for p, s in zip(acc_k, scales_k)
                     if p.duration <= cell_dl]
            if len(pairs) < len(acc_k):
                acc_k = [p for p, _ in pairs]
                scales_k = [s for _, s in pairs]
                lat_k = cell_dl
            else:
                lat_k = min(lat_k, cell_dl)
        if cell_ab:
            barrier = cell_dl if cell_dl is not None \
                else getattr(policy, "deadline", math.inf)
            lat_k = max(lat_k, min(barrier,
                                   max(p.completes_at - t_wall
                                       for p in cell_ab)))
        if acc_k:
            w_uns = [unnormalized_weight(rc.method, rc.use_aio, p.update,
                                         p.fedhq_level) * s
                     for p, s in zip(acc_k, scales_k)]
            if route == "streaming":
                edge = EdgeAggregator(k, sorted_params)
                for p, w_un in zip(acc_k, w_uns):
                    edge.absorb(p.update.values, p.update.mask, w_un)
                # the exact encoded size (planes + int8 scale headers)
                # is what the link serializes and the tariff charges
                enc = sim.encode_ship(k, edge.ship())
                parts.append((k, enc))
                bits = enc.bits
                if tel.enabled and sim.codec_ef is not None:
                    sim.learn.record_ef_residual(tel, k, round_idx,
                                                 sim.codec_ef)
            else:
                route_pairs.extend(zip(acc_k, w_uns))
                bits = payload_bits(tree_size(sorted_params),
                                    len(tree_leaves(sorted_params)),
                                    topo.backhaul.codec)
            t_ship, e_k = sim.cell_backhaul(k, t_wall).ship_bits(bits)
            bh_bits += bits
            e_ship += e_k
            ships.append((t_wall + lat_k + t_ship, k))
            lat = max(lat, lat_k + t_ship)
            n_rep += 1
            crit.append((lat_k + t_ship, lat_k, t_ship,
                         max(p.t_cmp for p in acc_k)))
            if tel.enabled:
                tel.span(f"cell/{k}", "backhaul_ship", t_wall + lat_k,
                         t_wall + lat_k + t_ship, round=round_idx,
                         bits=float(bits), codec=topo.backhaul.codec,
                         energy_j=e_k, n_updates=len(acc_k))
                tel.counter("cost.energy_j", e_k, cell=k,
                            phase="backhaul", round=round_idx)
                tel.counter("cost.comm_bits", float(bits), cell=k,
                            phase="backhaul", round=round_idx)
                tel.counter("backhaul.ships", 1.0, cell=k,
                            codec=topo.backhaul.codec, round=round_idx)
                for p, w_un in zip(acc_k, w_uns):
                    sim.learn.note_contribution(p.client_id, w_un)
        else:
            lat = max(lat, lat_k)
            crit.append((lat_k, lat_k, 0.0, 0.0))
        accepted_all.extend(acc_k)
    for t_arr, k in ships:      # record cloud arrival order
        queue.push(t_arr, ev_mod.EDGE_MERGE, k)
        if tel.enabled:
            tel.instant("server", "EDGE_MERGE", t_arr, cell=k,
                        round=round_idx)
    for _ in ships:
        queue.pop()
    new_params = None
    if parts:
        decoded = [(k, decode_partial(e)) for k, e in parts]
        cell_aggs = []
        if tel.enabled:
            # finalize each cell's aggregate now: the cloud merge below
            # writes into the first decoded partial's planes
            cell_aggs = [(k, aggregation.partial_finalize(d))
                         for k, d in decoded]
        # in place: the first decoded partial becomes the cloud's
        # accumulator (with f32, that is the edge's own planes)
        merged = cloud_merge([d for _, d in decoded])
        new_params = finalize_apply(sorted_params, merged,
                                    sim.server.server_lr)
        if tel.enabled:
            delta = tree_sub(sorted_params, new_params)
            for k, cell_agg in cell_aggs:
                sim.learn.record_cell(tel, k, round_idx, cell_agg, delta)
    elif route_pairs:              # batched: the flat (I, N) Eq. 5
        agg = aggregation.aio_aggregate(
            [p.update.values for p, _ in route_pairs],
            [p.update.mask for p, _ in route_pairs],
            torch.tensor([w for _, w in route_pairs], dtype=torch.float32))
        new_params = sim.server.apply_update(sorted_params, agg)
    # latency split along the critical cell: its barrier splits into
    # compute (until the slowest accepted T_cmp elapses) and uplink (the
    # rest); shipping is the backhaul share.  The three sum to lat.
    lat_parts = (0.0, 0.0, 0.0)
    if crit:
        _, bar, t_ship_c, max_tcmp = max(crit, key=lambda c: c[0])
        lt = min(bar, max_tcmp)
        lat_parts = (lt, bar - lt, t_ship_c)
    return (accepted_all, new_params, lat, e_ship, bh_bits, n_rep,
            lat_parts)


def _run_round_based(sim: Simulation, policy, orch: OrchestratorConfig,
                     verbose: bool) -> History:
    rc = sim.run_cfg
    use_pool = orch.use_pool if orch.use_pool is not None \
        else policy.pool_default
    tel = sim.tel
    queue = ev_mod.EventQueue(trace_limit=orch.event_trace_limit)
    hist = History(rc, [], registry=sim.registry)
    params = sim.params
    t_wall = 0.0

    for t in range(rc.rounds):
        # round-boundary handover, before dispatch, so the round's
        # channels, selection and edge merges see the new binding; one
        # HANDOVER event a move
        n_handover = 0
        if sim.handover is not None:
            new_cells, moves = sim.handover.reassign(
                sim.fleet.positions(t_wall), sim.fleet.cells)
            for i, old, new in moves:
                queue.push(t_wall, ev_mod.HANDOVER, i, (old, new))
                if tel.enabled:
                    tel.instant(f"device/{i}", "HANDOVER", t_wall,
                                round=t, src_cell=old, dst_cell=new)
                    tel.counter("mobility.handovers", 1.0, device=i,
                                round=t)
            for _ in moves:
                queue.pop()
            sim.fleet.cells = new_cells
            n_handover = len(moves)
        envs = sim.fleet.round_envs(sim.rng, sim.W, sim.S_bits, t=t_wall)
        sorted_params = sim.sort_params(params)
        sim.ensure_planner(sorted_params)

        selected, envs_eff, n_unavail, headroom = sim.gate_round(t_wall,
                                                                 envs)
        t_max_eff = sim.effective_T_max(t_wall)
        occupancy = int(np.bincount(sim.fleet.cells).max()) \
            if sim.fleet.cells is not None else 0
        pendings = [p for p in (sim.prepare(i, envs_eff[i])
                                for i in selected)
                    if p is not None]
        for p in pendings:
            sim.dispatch_log.append((t_wall, p.client_id,
                                     headroom[p.client_id]))
        if tel.enabled:
            tel.counter("fleet.unavailable", float(n_unavail), round=t)
            tel.counter("fleet.selected", float(len(selected)), round=t)
            tel.counter("fleet.infeasible",
                        float(len(selected) - len(pendings)), round=t)

        # mid-round churn: a device that leaves the cell before its
        # planned T_cmp + T_com elapses aborts; it is never trained or
        # compressed, and is charged its planned energy pro rata
        live, aborted = [], []
        for p in pendings:
            t_off = sim.fleet.next_departure(p.client_id, t_wall)
            planned = p.strat.T_cmp + p.strat.T_com
            if t_off < t_wall + planned:
                p.dispatched_at = t_wall
                p.completes_at = t_off
                frac = min(1.0, (t_off - t_wall) / planned) \
                    if planned > 0 else 1.0
                p.energy = frac * (p.strat.E_cmp + p.strat.E_com)
                p.e_cmp = frac * p.strat.E_cmp
                p.e_com = frac * p.strat.E_com
                aborted.append(p)
            else:
                live.append(p)

        jobs = [TrainJob(p.client_id, p.alpha, p.batches) for p in live]
        if use_pool:
            trained = sim.pool.train_shared(sorted_params, jobs)
        else:
            trained = [sim.train_one(p, sorted_params) for p in live]

        en, fl, cb = 0.0, 0.0, 0.0
        en_cmp = en_com = 0.0
        for p, j, tr in zip(live, jobs, trained):
            sim.materialize(p, tr, sorted_params, sub=j.sub_params)
            p.dispatched_at = t_wall
            p.completes_at = t_wall + p.duration
            # dispatch->arrival flight time goes to the always-live
            # registry (like the round.* gauges), so the dispatch latency
            # is queryable without a telemetry session
            # repro: ignore[unguarded-telemetry] — always-live by design
            sim.registry.observe("dispatch.latency_s", p.duration,
                                 device=p.client_id, cell=p.cell,
                                 round=t)
            queue.push(p.completes_at, ev_mod.COMPLETE, p.client_id, p)
            en += p.energy
            en_cmp += p.e_cmp
            en_com += p.e_com
            fl += p.update.flops
            cb += p.update.bits
            if tel.enabled:
                sub = j.sub_params if j.sub_params is not None \
                    else shrinking.shrink(sorted_params, p.alpha, sim.spec)
                sim.learn.record_device(
                    tel, p.client_id, t,
                    sim.learn.device_stats(p.alpha, sub, tr,
                                           p.update.values,
                                           p.update.mask))
                tel.span(f"device/{p.client_id}", "train", t_wall,
                         t_wall + p.t_cmp, round=t, cell=p.cell,
                         alpha=p.update.alpha, energy_j=p.e_cmp,
                         flops=p.update.flops)
                tel.span(f"device/{p.client_id}", "uplink",
                         t_wall + p.t_cmp, t_wall + p.duration, round=t,
                         cell=p.cell, bits=p.update.bits,
                         beta=p.update.beta_realized, energy_j=p.e_com)
                tel.counter("cost.energy_j", p.e_cmp,
                            device=p.client_id, cell=p.cell,
                            phase="train", round=t)
                tel.counter("cost.energy_j", p.e_com,
                            device=p.client_id, cell=p.cell,
                            phase="uplink", round=t)
                tel.counter("cost.comm_bits", p.update.bits,
                            device=p.client_id, cell=p.cell,
                            phase="uplink", round=t)
        for p in aborted:
            queue.push(p.completes_at, ev_mod.CHURN, p.client_id, p)
            en += p.energy
            en_cmp += p.e_cmp
            en_com += p.e_com
            if tel.enabled:
                tel.instant(f"device/{p.client_id}", "CHURN",
                            p.completes_at, round=t, cell=p.cell)
                tel.counter("cost.energy_j", p.e_cmp,
                            device=p.client_id, cell=p.cell,
                            phase="train", round=t)
                tel.counter("cost.energy_j", p.e_com,
                            device=p.client_id, cell=p.cell,
                            phase="uplink", round=t)
        for _ in range(len(live) + len(aborted)):  # record arrival order
            queue.pop()

        if not live:               # no device trained this round
            for p in aborted:
                sim.fleet.debit(p.client_id, p.energy, p.completes_at)
            hist.log_round(
                t, latency_s=0.0, energy_j=en, flops=0.0, comm_bits=0.0,
                mean_alpha=0.0, mean_beta=0.0, mean_gain=0.0,
                t_wall=t_wall, n_unavailable=n_unavail,
                n_aborted=len(aborted), mean_soc=sim.mean_soc(t_wall),
                n_handovers=n_handover, max_cell_occupancy=occupancy,
                t_max_effective=t_max_eff, energy_train_j=en_cmp,
                energy_uplink_j=en_com)
            if sim.fleet_dynamic:
                # the server idles a deadline, so that traces and
                # batteries move on (a static fleet must not drift)
                t_wall += sim.fleet_cfg.T_max
            continue

        bh_bits, n_cells_rep, e_ship = 0.0, 0, 0.0
        agg_delta = None
        if sim.topo is not None:
            (accepted, new_params, lat, e_ship, bh_bits, n_cells_rep,
             lat_parts) = _hier_round_merge(sim, policy, live, aborted,
                                            sorted_params, queue, t_wall,
                                            round_idx=t)
            en += e_ship
            t_wall += lat
            for p in live + aborted:
                sim.fleet.debit(p.client_id, p.energy, t_wall)
            if new_params is not None:
                params = new_params
                if tel.enabled:
                    agg_delta = tree_sub(sorted_params, new_params)
        else:
            accepted, scales, lat = policy.accept(live, 0.0)
            if aborted:
                # the server learns of a dropout at the departure, but
                # never waits past its own deadline barrier (semisync)
                barrier = getattr(policy, "deadline", math.inf)
                lat = max(lat, min(barrier,
                                   max(p.completes_at - t_wall
                                       for p in aborted)))
            # critical-path split: compute until the slowest accepted
            # client's T_cmp elapses, uplink/barrier wait for the rest
            lt = min(lat, max((p.t_cmp for p in accepted), default=0.0))
            lat_parts = (lt, lat - lt, 0.0)
            t_wall += lat
            for p in live + aborted:
                sim.fleet.debit(p.client_id, p.energy, t_wall)
            if accepted:
                w = apply_scales(base_weights(
                    rc.method, rc.use_aio, [p.update for p in accepted],
                    [p.fedhq_level for p in accepted]), scales)
                params = sim.aggregate(sorted_params, accepted, w)
                if tel.enabled:
                    agg_delta = tree_sub(sorted_params, params)
                    for p, wv in zip(accepted, w.tolist()):
                        sim.learn.note_contribution(p.client_id, wv)

        log = hist.log_round(
            t, latency_s=lat, energy_j=en, flops=fl, comm_bits=cb,
            mean_alpha=float(np.mean([p.update.alpha for p in live])),
            mean_beta=float(np.mean([p.update.beta_realized
                                     for p in live])),
            mean_gain=float(np.mean([p.strat.gain for p in live])),
            t_wall=t_wall, n_clients=len(accepted),
            n_dropped=len(live) - len(accepted),
            n_unavailable=n_unavail, n_aborted=len(aborted),
            mean_soc=sim.mean_soc(t_wall), t_max_effective=t_max_eff,
            n_cells_reporting=n_cells_rep, backhaul_bits=bh_bits,
            n_handovers=n_handover, max_cell_occupancy=occupancy,
            energy_train_j=en_cmp, energy_uplink_j=en_com,
            energy_backhaul_j=e_ship, latency_train_s=lat_parts[0],
            latency_uplink_s=lat_parts[1], latency_backhaul_s=lat_parts[2])
        if tel.enabled:
            if agg_delta is not None:
                for p in accepted:
                    sim.learn.record_alignment(tel, p.client_id, t,
                                               p.update.values, agg_delta)
            sim.learn.record_round(tel, t, agg_delta)
            tel.span("server", "round", t_wall - lat, t_wall, round=t,
                     n_clients=len(accepted), n_cells=n_cells_rep,
                     energy_j=en)
            if tel.health is not None:
                tel.health.evaluate(t, t_wall, sim.registry, tel)
        if t % rc.eval_every == 0 or t == rc.rounds - 1:
            acc, loss = sim.evaluate(params)
            hist.log_eval(log, acc, loss)
            if verbose:
                print(f"[{rc.method}/{policy.name}] round {t:3d} "
                      f"acc={acc:.3f} loss={loss:.3f} lat={lat:.2f}s "
                      f"E={en:.2f}J t={t_wall:.1f}s "
                      f"alpha={log.mean_alpha:.2f} "
                      f"beta={log.mean_beta:.4f}")
        if orch.max_wallclock_s is not None \
                and t_wall >= orch.max_wallclock_s:
            break
    hist.trace = queue.trace_signature()
    hist.dispatch_log = sim.dispatch_log
    hist.final_params = params
    return hist


# --------------------------------------------------------------- fedbuff mode

def _run_fedbuff(sim: Simulation, policy, orch: OrchestratorConfig,
                 verbose: bool) -> History:
    rc = sim.run_cfg
    use_pool = orch.use_pool if orch.use_pool is not None \
        else policy.pool_default
    retry_dt = orch.retry_interval_s if orch.retry_interval_s is not None \
        else sim.fleet_cfg.T_max
    if sim.dyn.selection != "uniform" or sim.dyn.participation < 1.0:
        print("[fedbuff] warning: selection policies and participation "
              "caps are round-based controls; fedbuff devices free-run "
              "(availability/battery gating still applies)")
    tel = sim.tel
    queue = ev_mod.EventQueue(trace_limit=orch.event_trace_limit)
    hist = History(rc, [], registry=sim.registry)

    # frozen sorted coordinate frame (cross-version merges need one frame)
    current = sim.sort_params(sim.params)
    sim.ensure_planner(current)
    version = 0
    version_params: dict[int, PyTree] = {0: current}
    inflight_version: dict[int, int] = {}
    buffer: list[PendingUpdate] = []
    n_agg = 0
    last_agg_t = 0.0
    en, fl, cb = 0.0, 0.0, 0.0
    en_cmp = en_com = 0.0
    # --max-inflight throttle: clients beyond the cap of concurrent
    # dispatched flights wait in FIFO order for a free slot
    cap = orch.max_inflight
    waiting: deque = deque()
    peak_inflight = 0

    def enqueue_flight(p: PendingUpdate, now: float) -> None:
        """COMPLETE at the planned arrival, unless the availability
        trace has the device leave the cell first (CHURN)."""
        nonlocal peak_inflight
        i = p.client_id
        inflight_version[i] = p.version
        peak_inflight = max(peak_inflight, len(inflight_version))
        # always-live registry write (host-side, never touches device
        # state), so the dispatch latency is queryable without a
        # telemetry session
        # repro: ignore[unguarded-telemetry] — always-live by design
        sim.registry.observe("dispatch.latency_s", p.completes_at - now,
                             device=p.client_id, version=p.version)
        t_off = sim.fleet.next_departure(i, now)
        if t_off < p.completes_at:
            queue.push(t_off, ev_mod.CHURN, i, p)
        else:
            queue.push(p.completes_at, ev_mod.COMPLETE, i, p)

    def gated(i: int, now: float) -> bool:
        """Availability and battery gates: an off-cell device RETRYs when
        its trace turns on, a drained one when the trickle restores its
        headroom (never, with no recharge).  True if it was gated."""
        fleet = sim.fleet
        if fleet.trace is not None and not fleet.trace.available(i, now):
            t_retry = fleet.trace.next_change(i, now)
        elif fleet.battery is not None \
                and not fleet.battery.available(i, now):
            t_retry = max(fleet.battery.ready_time(i, now), now + 1e-9)
        else:
            return False
        inflight_version.pop(i, None)
        if math.isfinite(t_retry):
            queue.push(t_retry, ev_mod.RETRY, i)
        return True

    def headroom(i: int, env: schedule.DeviceEnv, now: float) -> float:
        return sim.fleet.battery.headroom(i, now) \
            if sim.fleet.battery is not None else env.E_max

    def dispatch(i: int, env: schedule.DeviceEnv, now: float) -> None:
        if gated(i, now):
            return
        env = sim.fleet.dynamic_env(i, env, now)
        t_max_eff = sim.effective_T_max(now)
        if t_max_eff != sim.fleet_cfg.T_max:
            env = dataclasses.replace(env, T_max=t_max_eff)
        p = sim.prepare(i, env)
        if p is None:
            queue.push(now + retry_dt, ev_mod.RETRY, i)
            inflight_version.pop(i, None)
            return
        p.version = version
        p.dispatched_at = now
        # planned timeline: the device reserves compute + uplink by its plan
        t_cmp = p.alpha * env.tau * env.D * env.W / p.strat.freq
        t_com = p.alpha * p.strat.beta * env.S_bits / env.rate
        p.completes_at = now + t_cmp + t_com
        sim.dispatch_log.append((now, i, headroom(i, env, now)))
        enqueue_flight(p, now)

    def pump(now: float) -> None:
        """Fill free flight slots from the waiting FIFO, each on a fresh
        channel draw."""
        while waiting and (cap is None or len(inflight_version) < cap):
            j = waiting.popleft()
            dispatch(j, sim.fleet.device_env(sim.rng, j, sim.W, sim.S_bits,
                                             t=now), now)

    def redispatch(i: int, now: float) -> None:
        """Join the FIFO behind any earlier waiters, then fill the free
        slots; with no cap, an immediate dispatch."""
        waiting.append(i)
        pump(now)

    def requeue(p: PendingUpdate, now: float) -> None:
        """``requeue``: retrain the rejected round's exact minibatches and
        uniforms (its ``draw``) on the current version, a fresh flight of
        the same length.  It takes back the slot its own rejected flight
        just freed, outside the --max-inflight FIFO.  A device the gates
        now hold (out of the cell, or spent below its reserve) goes the
        gated dispatch path instead."""
        i = p.client_id
        if not sim.fleet.available(i, now):
            redispatch(i, now)
            return
        q = dataclasses.replace(p, version=version, dispatched_at=now,
                                staleness=0, update=None)
        q.completes_at = now + (p.completes_at - p.dispatched_at)
        sim.dispatch_log.append((now, i, headroom(i, p.env, now)))
        enqueue_flight(q, now)

    for i, env in enumerate(sim.fleet.round_envs(sim.rng, sim.W,
                                                 sim.S_bits)):
        if cap is not None and len(inflight_version) >= cap:
            waiting.append(i)
        else:
            dispatch(i, env, 0.0)

    # progress guard: without a wall-clock budget the run targets
    # rc.rounds merges, but an all-infeasible fleet would retry forever;
    # budget enough simulated time for every merge even if one device
    # alone is ever feasible, then stop
    wall_limit = orch.max_wallclock_s
    if wall_limit is None:
        cycle = max(sim.fleet_cfg.T_max, retry_dt)
        wall_limit = rc.rounds * orch.buffer_size * cycle * 4.0

    now = 0.0
    n_stale = n_aborted = 0
    while len(queue):
        ev = queue.pop()
        if ev.time > wall_limit:
            break
        now = ev.time
        if ev.kind == ev_mod.RETRY:
            if tel.enabled:
                tel.instant(f"device/{ev.client}", "RETRY", now)
                tel.counter("fedbuff.retries", 1.0, device=ev.client)
            redispatch(ev.client, now)
            continue
        if ev.kind == ev_mod.CHURN:
            # the device left the cell mid-flight: abort, charge the
            # planned energy pro rata, come back when the trace does
            p = ev.payload
            planned = p.completes_at - p.dispatched_at
            frac = min(1.0, (now - p.dispatched_at) / planned) \
                if planned > 0 else 1.0
            waste = frac * (p.strat.E_cmp + p.strat.E_com)
            en += waste
            en_cmp += frac * p.strat.E_cmp
            en_com += frac * p.strat.E_com
            if tel.enabled:
                tel.instant(f"device/{p.client_id}", "CHURN", now,
                            version=p.version)
                tel.counter("cost.energy_j", frac * p.strat.E_cmp,
                            device=p.client_id, phase="train")
                tel.counter("cost.energy_j", frac * p.strat.E_com,
                            device=p.client_id, phase="uplink")
            sim.fleet.debit(p.client_id, waste, now)
            n_aborted += 1
            inflight_version.pop(p.client_id, None)
            t_on = sim.fleet.trace.next_change(p.client_id, now)
            if math.isfinite(t_on):
                queue.push(t_on, ev_mod.RETRY, p.client_id)
            pump(now)      # the aborted flight freed a throttle slot
            continue

        p = ev.payload
        inflight_version.pop(p.client_id, None)   # flight landed
        p.staleness = version - p.version
        # the device spent its planned energy whether or not the server
        # admits the update (the energy log keeps the realized costs)
        sim.fleet.debit(p.client_id, p.strat.E_cmp + p.strat.E_com, now)
        if not policy.admit(p.staleness):
            n_stale += 1
            en += p.strat.E_cmp + p.strat.E_com   # spent, never aggregated
            en_cmp += p.strat.E_cmp
            en_com += p.strat.E_com
            if tel.enabled:
                tel.instant(f"device/{p.client_id}", "STALE_REJECT",
                            now, staleness=p.staleness)
                tel.counter("cost.energy_j", p.strat.E_cmp,
                            device=p.client_id, phase="train")
                tel.counter("cost.energy_j", p.strat.E_com,
                            device=p.client_id, phase="uplink")
            if orch.staleness_mode == STALE_REQUEUE:
                requeue(p, now)
            else:
                redispatch(p.client_id, now)
            continue
        buffer.append(p)
        redispatch(p.client_id, now)

        if not policy.should_aggregate(buffer):
            continue

        # ---- materialize the buffered rounds (deferred, batched training)
        shrunk: dict = {}
        jobs = []
        for b in buffer:
            vk = (b.version, b.alpha)
            if vk not in shrunk:
                shrunk[vk] = shrinking.shrink(version_params[b.version],
                                              b.alpha, sim.spec)
            jobs.append(TrainJob(b.client_id, b.alpha, b.batches,
                                 sub_params=shrunk[vk]))
        if use_pool:
            trained = sim.pool.train_stacked(jobs)
        else:
            trained = [sim.client._local_steps(j.sub_params, j.batches)
                       for j in jobs]
        # stream each decoded update into one O(N) AIO accumulator and drop
        # it on the spot: unnormalized weights times the staleness
        # discount (Eq. 5's ratio cancels the cohort normalization)
        stream_acc = EdgeAggregator(-1, current)
        gamma = orch.staleness_exponent
        for b, j, tr in zip(buffer, jobs, trained):
            sim.materialize(b, tr, version_params[b.version],
                            sub=j.sub_params)
            en += b.energy
            en_cmp += b.e_cmp
            en_com += b.e_com
            fl += b.update.flops
            cb += b.update.bits
            if tel.enabled:
                sim.learn.record_device(
                    tel, b.client_id, n_agg,
                    sim.learn.device_stats(b.alpha, j.sub_params, tr,
                                           b.update.values,
                                           b.update.mask))
                tel.span(f"device/{b.client_id}", "train",
                         b.dispatched_at, b.dispatched_at + b.t_cmp,
                         version=b.version, staleness=b.staleness,
                         alpha=b.update.alpha, energy_j=b.e_cmp)
                tel.span(f"device/{b.client_id}", "uplink",
                         b.dispatched_at + b.t_cmp,
                         b.dispatched_at + b.duration,
                         version=b.version, bits=b.update.bits,
                         energy_j=b.e_com)
                tel.counter("cost.energy_j", b.e_cmp,
                            device=b.client_id, phase="train")
                tel.counter("cost.energy_j", b.e_com,
                            device=b.client_id, phase="uplink")
                tel.counter("cost.comm_bits", b.update.bits,
                            device=b.client_id, phase="uplink")
            w_b = unnormalized_weight(rc.method, rc.use_aio, b.update,
                                      b.fedhq_level) \
                * staleness_scales([b.staleness], gamma)[0]
            stream_acc.absorb(b.update.values, b.update.mask, w_b)
            if tel.enabled:
                # keep the decoded update until the post-merge alignment
                # pass below: a telemetry-only memory cost of one
                # buffer's worth of updates
                sim.learn.note_contribution(b.client_id, float(w_b))
            else:
                b.update = dataclasses.replace(b.update, values=None,
                                               mask=None)
        prev_current = current
        current = finalize_apply(current, stream_acc.ship(),
                                 sim.server.server_lr)
        if tel.enabled:
            agg_delta = tree_sub(prev_current, current)
            for b in buffer:
                sim.learn.record_alignment(tel, b.client_id, n_agg,
                                           b.update.values, agg_delta)
                b.update = dataclasses.replace(b.update, values=None,
                                               mask=None)
            sim.learn.record_round(tel, n_agg, agg_delta)
        version += 1
        version_params[version] = current
        # keep only the versions an in-flight client still trains on
        keep = set(inflight_version.values()) | {version}
        for v in [v for v in version_params if v not in keep]:
            del version_params[v]
        n_agg += 1
        if tel.enabled:
            tel.instant("server", "BUFFER_MERGE", now, version=version,
                        n_updates=len(buffer))

        # latency split along the merge's triggering arrival (buffer[-1]):
        # its training inside [last_agg_t, now] is the compute share, the
        # rest (its wire time and the wait on the earlier arrivals) uplink
        lat = now - last_agg_t
        trig = buffer[-1]
        lo = max(trig.dispatched_at, last_agg_t)
        compute_end = min(trig.dispatched_at + trig.t_cmp, now)
        lat_train = max(0.0, compute_end - lo)
        log = hist.log_round(
            n_agg - 1, latency_s=lat, energy_j=en, flops=fl, comm_bits=cb,
            mean_alpha=float(np.mean([b.update.alpha for b in buffer])),
            mean_beta=float(np.mean([b.update.beta_realized
                                     for b in buffer])),
            mean_gain=float(np.mean([b.strat.gain for b in buffer])),
            t_wall=now, n_clients=len(buffer),
            mean_staleness=float(np.mean([b.staleness for b in buffer])),
            max_staleness=int(max(b.staleness for b in buffer)),
            n_stale_dropped=n_stale, n_aborted=n_aborted,
            mean_soc=sim.mean_soc(now),
            t_max_effective=sim.effective_T_max(now),
            energy_train_j=en_cmp, energy_uplink_j=en_com,
            latency_train_s=lat_train, latency_uplink_s=lat - lat_train)
        if tel.enabled and tel.health is not None:
            tel.health.evaluate(n_agg - 1, now, sim.registry, tel)
        done = orch.max_wallclock_s is None and n_agg >= rc.rounds
        if (n_agg - 1) % rc.eval_every == 0 or done:
            acc, loss = sim.evaluate(current)
            hist.log_eval(log, acc, loss)
            if verbose:
                print(f"[{rc.method}/fedbuff] merge {n_agg:3d} "
                      f"t={now:7.1f}s acc={acc:.3f} loss={loss:.3f} "
                      f"stale={log.mean_staleness:.1f} "
                      f"alpha={log.mean_alpha:.2f}")
        buffer = []
        en, fl, cb = 0.0, 0.0, 0.0
        en_cmp = en_com = 0.0
        n_stale = n_aborted = 0
        last_agg_t = now
        if done:
            break

    # final eval, so best_acc reflects the last merged model
    if hist.rounds and hist.rounds[-1].test_acc is None:
        acc, loss = sim.evaluate(current)
        hist.log_eval(hist.rounds[-1], acc, loss)
    hist.trace = queue.trace_signature()
    hist.dispatch_log = sim.dispatch_log
    hist.peak_inflight = peak_inflight
    hist.final_params = current
    return hist


def run_orchestrated(run_cfg: FLRunConfig,
                     fleet_cfg: Optional[FleetConfig] = None,
                     orch: Optional[OrchestratorConfig] = None, *,
                     device="cuda", verbose: bool = False,
                     uniforms: Optional[UniformSource] = None,
                     telemetry=None) -> History:
    """Run federated training under an arrival/aggregation policy (sync,
    semisync or fedbuff) on ``device`` (``cuda`` unless the caller asks
    for the CPU), on a flat or a hierarchical fleet; ``uniforms``
    replaces the default uniform source.  ``telemetry`` is an optional
    :class:`repro_torch.telemetry.Telemetry` session; without one (or
    with ``NULL_TELEMETRY``) the run records only the always-live
    registry and gives the same result bit for bit."""
    orch = orch or OrchestratorConfig()
    sim = Simulation(run_cfg, fleet_cfg, device=device, uniforms=uniforms,
                     telemetry=telemetry)
    sim.agg_route = sim.resolve_agg_route(orch.agg_route)
    policy = make_policy(orch, fleet_T_max=sim.fleet_cfg.T_max)
    if not policy.round_based and sim.topo is not None:
        raise ValueError(
            "hierarchical topology needs a round-based policy "
            "(sync/semisync): fedbuff's cross-version stream has no "
            "per-cell round barrier to ship partials at")
    runner = _run_round_based if policy.round_based else _run_fedbuff
    if sim.tel.enabled and sim.tel.torch_profile:
        with profile_trace(sim.tel.out_dir):
            return runner(sim, policy, orch, verbose)
    return runner(sim, policy, orch, verbose)
