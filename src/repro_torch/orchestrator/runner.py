"""FL runner over the discrete-event engine: the synchronous round on a
static fleet, flat or hierarchical, for every method of
``train/fl_loop.METHODS``.

``train/fl_loop.run_fl`` builds a :class:`Simulation` and runs
:func:`_run_round_based` with the sync policy.  ``anycostfl`` solves
Problem (P4) per device and compresses with FGC; ``use_ems``,
``use_fgc`` and ``use_aio`` switch off one component each (Fig. 5a).
The baselines (``stc``, ``qsgd``, ``uveqfed``, ``heterofl``, ``fedhq``,
``fedavg``) take their strategy and compressor from
``train/baselines.BaselinePolicy`` and never sit a round out; the
weights follow the method (``policies.base_weights``).

**Hierarchical topologies** (``FleetConfig.topology`` of kind ``hier``):
devices are partitioned into cells, each with its own wireless
environment; each cell's edge applies the arrival policy to its own
arrivals, folds the accepted updates into one O(N) streaming partial
with *unnormalized* coefficients (``aio_absorb``, in place), and ships it
over the modelled backhaul, through the wire codec; the cloud merges the
partials (EDGE_MERGE events, ``aio_merge`` in place) and finalizes Eq. 5
once (:func:`_hier_round_merge`).  ``OrchestratorConfig.agg_route``
``batched`` aggregates the same accepted updates with the flat Eq. 5
(``aio_aggregate``) instead, charging the same backhaul costs.  The numpy generator is
consumed in the reference's order (``repro/orchestrator/runner.py``):
setup (task data, partition, fleet), then per round the channel draws,
the planner's probe permutation (first round only) and each device's
minibatch draws, so one seed gives the reference's data, fleet, channels
and strategies.

Randomness the reference draws from its JAX key chain (the planner's
probe quantization and each device's quantization uniforms) comes from
an injectable *uniform source* instead, split at the same two places
the reference splits its key.  By default it is a ``torch.Generator`` on
the run's device; tests hand in a source that replays the reference's
key chain.
"""
from __future__ import annotations

import dataclasses
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
from repro_torch.models import cnn as cnn_mod
from repro_torch.models.registry import build_model
from repro_torch.orchestrator import events as ev_mod
from repro_torch.orchestrator.policies import (OrchestratorConfig,
                                               SyncPolicy, apply_scales,
                                               base_weights,
                                               unnormalized_weight)
from repro_torch.sysmodel.population import FleetConfig, make_fleet
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
#: n -> (n,) float32 uniforms in [0, 1) on the run's device
Draw = Callable[[int], torch.Tensor]


class UniformSource(Protocol):
    """Where the run's quantization uniforms come from."""

    def planner_stream(self) -> Draw:
        """The planner's probe draw (the reference's one 2-way key split)."""

    def device_stream(self) -> Draw:
        """One prepared device's draw (the reference's 3-way key split)."""


class TorchUniforms:
    """The default uniform source: a seeded ``torch.Generator`` on the
    run's device hands each split a child generator of its own."""

    def __init__(self, seed: int, device):
        self.device = torch.device(device)
        self._gen = torch.Generator(device=self.device).manual_seed(seed)

    def _child(self) -> Draw:
        seed = int(torch.randint(0, 2 ** 62, (1,), generator=self._gen,
                                 device=self.device))
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return lambda n: torch.rand(n, generator=gen, device=self.device)

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
    cell: int = 0                # serving cell at dispatch: the update
                                 # merges at the edge that dispatched it
    dispatched_at: float = 0.0
    completes_at: float = 0.0
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
                 device="cuda", uniforms: Optional[UniformSource] = None):
        if run_cfg.method not in METHODS:
            raise ValueError(f"unknown method {run_cfg.method!r}; expected "
                             f"one of {METHODS}")
        self.device = resolve_device(device)
        self.run_cfg = run_cfg
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

        # hierarchical topology (None -> the paper's flat single cell)
        topo = fleet_cfg.topology
        self.topo = topo if topo is not None and topo.kind == "hier" \
            else None
        self.cell_backhauls = self.topo.cell_backhauls() \
            if self.topo is not None else None
        self.codec_ef = None
        self._ef_frame = None
        if self.topo is not None and self.topo.backhaul.error_feedback:
            self.codec_ef = CodecErrorFeedback()
        # set from OrchestratorConfig.agg_route by run_orchestrated
        self.agg_route = "streaming"

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
                    sorted_params: PyTree) -> PendingUpdate:
        """Decode the trained sub-model into a ClientUpdate + realized costs
        (Eq. 6-9), with the reference's float-op order."""
        rc = self.run_cfg
        env, strat = p.env, p.strat
        if self.baseline is None:
            upd = self.client.finish_round(
                sorted_params, p.alpha, trained, strat, p.n_steps,
                p.draw(self._n_params),
                planner=self.planner if rc.use_fgc else None,
                w_per_sample=self.W)
            if not rc.use_fgc:
                # transmit the raw (width-masked) update
                upd = dataclasses.replace(
                    upd, bits=32.0 * strat.alpha * self._n_params,
                    beta_realized=1.0)
        else:
            sub = shrinking.shrink(sorted_params, p.alpha, self.spec)
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
        return self.server.aggregate(sorted_params,
                                     [p.update for p in accepted],
                                     weights=weights)

    def evaluate(self, params: PyTree) -> tuple[float, float]:
        acc, loss = self.ev(params)
        return float(acc), float(loss)

    # --------------------------------------------------- hierarchical glue

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

def _hier_round_merge(sim: Simulation, policy: SyncPolicy,
                      live: list[PendingUpdate], sorted_params: PyTree,
                      queue: ev_mod.EventQueue, t_wall: float):
    """One hierarchical round tail: per-cell accept -> edge absorb ->
    backhaul ship -> cloud merge.

    Each cell applies the arrival policy to its own arrivals (trimmed to
    ``cell_deadline_s`` when set), folds the accepted updates into its
    partial with unnormalized coefficients, and ships it; the round
    lasts until the slowest cell's barrier plus its shipping time.
    Membership is the cell recorded on each flight at dispatch.

    Returns ``(accepted, new_params or None, lat, ship_energy,
    backhaul_bits, n_cells_reporting, lat_parts)``; ``lat_parts`` splits
    ``lat`` into (train, uplink, backhaul) along the critical cell."""
    topo, fleet, rc = sim.topo, sim.fleet, sim.run_cfg
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
        if not cell_live:
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
                parts.append(enc)
                bits = enc.bits
            else:
                route_pairs.extend(zip(acc_k, w_uns))
                bits = payload_bits(tree_size(sorted_params),
                                    len(tree_leaves(sorted_params)),
                                    topo.backhaul.codec)
            t_ship, e_k = sim.cell_backhauls[k].ship_bits(bits)
            bh_bits += bits
            e_ship += e_k
            ships.append((t_wall + lat_k + t_ship, k))
            lat = max(lat, lat_k + t_ship)
            n_rep += 1
            crit.append((lat_k + t_ship, lat_k, t_ship,
                         max(p.t_cmp for p in acc_k)))
        else:
            lat = max(lat, lat_k)
            crit.append((lat_k, lat_k, 0.0, 0.0))
        accepted_all.extend(acc_k)
    for t_arr, k in ships:      # record cloud arrival order
        queue.push(t_arr, ev_mod.EDGE_MERGE, k)
    for _ in ships:
        queue.pop()
    new_params = None
    if parts:
        # in place: the first decoded partial becomes the cloud's
        # accumulator (with f32, that is the edge's own planes)
        merged = cloud_merge([decode_partial(e) for e in parts])
        new_params = finalize_apply(sorted_params, merged,
                                    sim.server.server_lr)
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


def _run_round_based(sim: Simulation, policy: SyncPolicy,
                     orch: OrchestratorConfig, verbose: bool) -> History:
    rc = sim.run_cfg
    queue = ev_mod.EventQueue()
    hist = History(rc, [])
    params = sim.params
    t_wall = 0.0
    T_max = sim.fleet_cfg.T_max

    for t in range(rc.rounds):
        envs = sim.fleet.round_envs(sim.rng, sim.W, sim.S_bits)
        sorted_params = sim.sort_params(params)
        sim.ensure_planner(sorted_params)
        live = [p for p in (sim.prepare(i, env) for i, env in enumerate(envs))
                if p is not None]
        trained = [sim.train_one(p, sorted_params) for p in live]

        en, fl, cb = 0.0, 0.0, 0.0
        en_cmp = en_com = 0.0
        for p, tr in zip(live, trained):
            sim.materialize(p, tr, sorted_params)
            p.dispatched_at = t_wall
            p.completes_at = t_wall + p.duration
            queue.push(p.completes_at, ev_mod.COMPLETE, p.client_id, p)
            en += p.energy
            en_cmp += p.e_cmp
            en_com += p.e_com
            fl += p.update.flops
            cb += p.update.bits
        for _ in range(len(live)):  # record arrival order
            queue.pop()

        if not live:               # no device found a feasible strategy
            hist.log_round(t, latency_s=0.0, energy_j=en, flops=0.0,
                           comm_bits=0.0, mean_alpha=0.0, mean_beta=0.0,
                           mean_gain=0.0, t_wall=t_wall,
                           t_max_effective=T_max)
            continue

        bh_bits, n_cells_rep, e_ship = 0.0, 0, 0.0
        if sim.topo is not None:
            (accepted, new_params, lat, e_ship, bh_bits, n_cells_rep,
             lat_parts) = _hier_round_merge(sim, policy, live,
                                            sorted_params, queue, t_wall)
            en += e_ship
            t_wall += lat
            if new_params is not None:
                params = new_params
        else:
            accepted, scales, lat = policy.accept(live, 0.0)
            # critical-path split: compute until the slowest accepted
            # client's T_cmp elapses, uplink/barrier wait for the rest
            lt = min(lat, max((p.t_cmp for p in accepted), default=0.0))
            lat_parts = (lt, lat - lt, 0.0)
            t_wall += lat
            if accepted:
                w = apply_scales(base_weights(
                    rc.method, rc.use_aio, [p.update for p in accepted],
                    [p.fedhq_level for p in accepted]), scales)
                params = sim.aggregate(sorted_params, accepted, w)

        log = hist.log_round(
            t, latency_s=lat, energy_j=en, flops=fl, comm_bits=cb,
            mean_alpha=float(np.mean([p.update.alpha for p in live])),
            mean_beta=float(np.mean([p.update.beta_realized
                                     for p in live])),
            mean_gain=float(np.mean([p.strat.gain for p in live])),
            t_wall=t_wall, n_clients=len(accepted),
            n_dropped=len(live) - len(accepted), t_max_effective=T_max,
            n_cells_reporting=n_cells_rep, backhaul_bits=bh_bits,
            energy_train_j=en_cmp, energy_uplink_j=en_com,
            energy_backhaul_j=e_ship, latency_train_s=lat_parts[0],
            latency_uplink_s=lat_parts[1], latency_backhaul_s=lat_parts[2])
        if t % rc.eval_every == 0 or t == rc.rounds - 1:
            acc, loss = sim.evaluate(params)
            hist.log_eval(log, acc, loss)
            if verbose:
                print(f"[{rc.method}/{policy.name}] round {t:3d} "
                      f"acc={acc:.3f} loss={loss:.3f} lat={lat:.2f}s "
                      f"E={en:.2f}J t={t_wall:.1f}s "
                      f"alpha={log.mean_alpha:.2f} "
                      f"beta={log.mean_beta:.4f}")
    hist.trace = queue.trace_signature()
    hist.final_params = params
    return hist


def run_orchestrated(run_cfg: FLRunConfig,
                     fleet_cfg: Optional[FleetConfig] = None,
                     orch: Optional[OrchestratorConfig] = None, *,
                     device="cuda", verbose: bool = False) -> History:
    """Run federated training under an arrival/aggregation policy (sync),
    on a flat or a hierarchical fleet."""
    orch = orch or OrchestratorConfig()
    sim = Simulation(run_cfg, fleet_cfg, device=device)
    sim.agg_route = sim.resolve_agg_route(orch.agg_route)
    return _run_round_based(sim, SyncPolicy(orch), orch, verbose)

