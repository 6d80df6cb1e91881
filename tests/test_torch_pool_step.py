"""The client pool's vmapped CNN step with the lane axis written out
(``models/cnn_lanes``), on the CPU.

``AnycostClient._local_steps_batched`` runs a CNN's forward and backward
through the lane functions; it is held here against vmap's per-op
batching of the model's own forward (the generic lane function:
``torch.func.vmap`` of ``torch.func.grad`` of ``loss_fn``), for both
CNNs at the widths 0.25, 0.4 and 1.0, from one shared model and from
stacked per-lane models, 3 lanes, 2 steps, on the synthetic task's
images: parameters within rtol 1e-5, beside an absolute 1e-5 of the
leaf's largest magnitude, in float64.  Not in float32: the images are
clipped to [0, 1], so windows of equal pixels give equal convolution
outputs, and a max-pool breaks such a tie by the rounding of the
convolution that computed them; two float32 runs that sum in other
orders route a lane's gradient through another pixel now and then
(seen at 3e-3 of a leaf after two steps, vmap's batching or the batched
GEMMs against each client's own loop, ``_local_steps``).  Float64 keeps
the ties and the arithmetic alike, so any difference left is the
code's.
Then the interface the benchmark's step check reads: one
``torch.func.vmap`` call a step of each group, its first step of
``train_shared`` with ``in_dims`` ``(None, 0)`` and the shared tree, the
later ones with ``(0, 0)`` and the stacked HWIO tree, and the recorder's
``train.lane_steps`` counting every lane's step.  Both formulations of
the lanes' convolutions run here: one framework convolution a lane (the
CPU's) and the batched GEMMs (the card's).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import shrinking  # noqa: E402
from repro_torch.core.anycost import AnycostClient  # noqa: E402
from repro_torch.data.synthetic import make_image_task  # noqa: E402
from repro_torch.models import cnn, cnn_lanes  # noqa: E402
from repro_torch.models.registry import build_model, loss_fn  # noqa: E402
from repro_torch.orchestrator.client_pool import (ClientPool,  # noqa: E402
                                                  TrainJob)
from repro_torch.telemetry import wallclock  # noqa: E402
from repro_torch.utils.pytree import (tree_leaves, tree_map,  # noqa: E402
                                      tree_unflatten)

torch.set_num_threads(1)

LANES, STEPS, BATCH = 3, 2, 8


def _setup(name, seed=0):
    cfg = get_config(name)
    model = build_model(cfg)
    client = AnycostClient(model, shrinking.cnn_shrink_spec(cfg), lr=0.1,
                           batch_size=BATCH)
    params = shrinking.sort_channels(
        model.init(torch.Generator().manual_seed(seed), "cpu"), client.spec)
    rng = np.random.default_rng(seed)
    n = LANES * STEPS * BATCH
    task, _ = make_image_task(rng, n, 8, shape=cnn.image_shape(cfg))
    order = rng.permutation(n).reshape(LANES, STEPS, BATCH)
    batches = {"images": torch.tensor(task.x[order]),
               "labels": torch.tensor(task.y[order])}
    return client, params, batches


def _double(tree):
    return tree_map(lambda x: x.double() if x.is_floating_point() else x,
                    tree)


def _assert_close(got, want):
    for x, y in zip(got, want):
        torch.testing.assert_close(x, y, rtol=1e-5,
                                   atol=1e-5 * float(y.abs().max()))


def _vmap_grad_steps(client, params, batches, shared):
    """The generic lane function: vmap's per-op batching of the model's
    own forward, the pool's update."""
    model, lr = client.model, client.lr
    grad = torch.func.grad(lambda q, batch: loss_fn(model, q, batch))
    p, in_dims = params, None if shared else 0
    for s in range(batches["images"].shape[1]):
        batch = {k: v[:, s] for k, v in batches.items()}
        g = torch.func.vmap(grad, in_dims=(in_dims, 0))(p, batch)
        p = tree_map(lambda a, b: a - lr * b, p, g)
        in_dims = 0
    return p


@pytest.mark.parametrize("gemm", [False, True], ids=["per_lane", "gemm"])
@pytest.mark.parametrize("shared", [True, False], ids=["shared", "stacked"])
@pytest.mark.parametrize("alpha", [0.25, 0.4, 1.0])
@pytest.mark.parametrize("name", ["fmnist-cnn", "vgg9-cifar"])
def test_the_written_out_step_matches_vmap_of_grad(monkeypatch, name, alpha,
                                                   shared, gemm):
    monkeypatch.setattr(cnn_lanes, "_gemm", lambda x: gemm)
    client, params, batches = _setup(name)
    sub = shrinking.shrink(params, alpha, client.spec)
    if not shared:
        sub = tree_map(lambda x: torch.stack(
            [x * (1.0 - 0.01 * j) for j in range(LANES)]), sub)
    sub, batches = _double(sub), _double(batches)
    with wallclock.recording() as rec:
        got = client._local_steps_batched(sub, batches, shared=shared)
    assert rec.counters() == {"train.lane_steps": LANES * STEPS}
    want = _vmap_grad_steps(client, sub, batches, shared)
    for x, y in zip(tree_leaves(got), tree_leaves(want)):
        assert x.shape == y.shape and x.shape[0] == LANES
        assert x.dtype == torch.float64
    _assert_close(tree_leaves(got), tree_leaves(want))


@pytest.mark.parametrize("gemm", [False, True], ids=["per_lane", "gemm"])
def test_one_lane_outside_vmap_is_the_models_gradient(monkeypatch, gemm):
    """Called outside vmap, the lane functions run one lane: the same
    gradient as autograd through ``cnn.apply_cnn``."""
    monkeypatch.setattr(cnn_lanes, "_gemm", lambda x: gemm)
    client, params, batches = _setup("vgg9-cifar")
    sub = _double(shrinking.shrink(params, 0.4, client.spec))
    batch = _double({k: v[0, 0] for k, v in batches.items()})
    leaves = [t.clone().requires_grad_() for t in tree_leaves(sub)]
    want = torch.autograd.grad(
        loss_fn(client.model, tree_unflatten(sub, leaves), batch), leaves)
    logits = client.model._replace(forward=lambda z, b, **kw: z)
    got = cnn_lanes.lane_grad(lambda z, b: loss_fn(logits, z, b))(sub, batch)
    grads = [tree_leaves(got), want]
    _assert_close(*grads)


@pytest.mark.parametrize("stacked", [False, True],
                         ids=["train_shared", "train_stacked"])
def test_each_step_is_one_vmap_call_the_check_can_follow(monkeypatch,
                                                          stacked):
    """A pooled round of two widths, 3 lanes each, 2 steps: the
    benchmark's step check wraps ``torch.func.vmap`` and reads each
    step's parameters and minibatch at that call."""
    client, params, batches = _setup("fmnist-cnn")
    alphas = [0.25, 1.0, 0.25, 1.0, 0.25, 1.0]
    jobs_b = [{k: v[j % LANES] for k, v in batches.items()}
              for j in range(len(alphas))]
    calls = []
    vmap = torch.func.vmap

    def vmap_w(fn, *a, **kw):
        batched = vmap(fn, *a, **kw)

        def call(p, batch):
            calls.append((kw["in_dims"], p, batch))
            return batched(p, batch)
        return call

    monkeypatch.setattr(torch.func, "vmap", vmap_w)
    pool = ClientPool(client)
    subs = {a: shrinking.shrink(params, a, client.spec) for a in (0.25, 1.0)}
    jobs = [TrainJob(j, a, b, sub_params=subs[a] if stacked else None)
            for j, (a, b) in enumerate(zip(alphas, jobs_b))]
    with wallclock.recording() as rec:
        if stacked:
            pool.train_stacked(jobs)
        else:
            pool.train_shared(params, jobs)
    assert len(calls) == 2 * STEPS          # one a step of each group
    for k, (in_dims, p, batch) in enumerate(calls):
        alpha = alphas[k // STEPS]
        start = tree_leaves(subs[alpha])
        assert batch["images"].shape == (LANES, BATCH, 28, 28, 1)
        if k % STEPS == 0 and not stacked:
            assert in_dims == (None, 0)
            # the group's one shrunk model, which the decode reads too
            assert p is jobs[k // STEPS].sub_params
            assert [x.shape for x in tree_leaves(p)] == \
                [x.shape for x in start]
        else:
            assert in_dims == (0, 0)
            # the stacked HWIO tree: a lane axis before each leaf's own
            assert [x.shape for x in tree_leaves(p)] == \
                [(LANES, *x.shape) for x in start]
            assert p["conv1"]["w"].shape[1:] == \
                subs[alpha]["conv1"]["w"].shape
    assert rec.counters() == {"train.lane_steps": 2 * LANES * STEPS}


@pytest.mark.parametrize("stacked", [False, True],
                         ids=["train_shared", "train_stacked"])
def test_a_group_the_card_cannot_hold_trains_in_runs(monkeypatch, stacked):
    """Six lanes of one width where the memory holds four: two runs, of
    four lanes and of two, each a ``_run_group`` of its own (the
    benchmark's step check follows a group there), with the parameters
    of one run of all six."""
    client, params, batches = _setup("fmnist-cnn")
    jobs_b = [{k: v[j % LANES] for k, v in batches.items()}
              for j in range(6)]
    sub = shrinking.shrink(params, 0.4, client.spec)

    def train(pool):
        jobs = [TrainJob(j, 0.4, b, sub_params=tree_map(
            lambda x, j=j: x * (1.0 - 0.01 * j), sub) if stacked else None)
            for j, b in enumerate(jobs_b)]
        return pool.train_stacked(jobs) if stacked else \
            pool.train_shared(params, jobs)

    assert cnn_lanes.lanes_that_fit(sub, jobs_b[0]["images"]) >= 6
    want = train(ClientPool(client))
    pool, runs = ClientPool(client), []
    run_group = pool._run_group

    def run_group_w(idxs, *a, **kw):
        runs.append(list(idxs))
        return run_group(idxs, *a, **kw)

    monkeypatch.setattr(pool, "_run_group", run_group_w)
    monkeypatch.setattr(cnn_lanes, "lanes_that_fit", lambda p, images: 4)
    got = train(pool)
    assert runs == [[0, 1, 2, 3], [4, 5]]
    for g, w in zip(got, want):
        _assert_close(tree_leaves(g), tree_leaves(w))


@pytest.mark.parametrize("name", ["fmnist-cnn", "vgg9-cifar"])
def test_lane_bytes_counts_what_the_forward_keeps(monkeypatch, name):
    """``lane_bytes`` at least counts, for each lane, its minibatches, the
    step's three copies of the parameters and what the batched GEMMs'
    forward keeps for the backward, read off the forward's own saved
    tensors (one lane, full width, one step)."""
    monkeypatch.setattr(cnn_lanes, "_gemm", lambda x: True)
    client, params, batches = _setup(name)
    images = batches["images"][0]            # (steps, BATCH, H, W, C)
    leaves = tree_leaves(params)
    convs, acts, _ = cnn_lanes._forward(cnn_lanes.plan(params),
                                        images[None, 0],
                                        [t[None] for t in leaves])[1]
    saved = sum(t.nbytes for c in convs for t in c if t is not None) \
        + sum(t.nbytes for t in acts)
    assert cnn_lanes.lane_bytes(params, images) >= \
        saved + images.nbytes + 3 * sum(t.nbytes for t in leaves)
