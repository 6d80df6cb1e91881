from repro_torch.core import aggregation
from repro_torch.kernels import ops


def stale_plane(num, den, u, m, w):
    before = num
    ops.aio_absorb_op(num, den, u, m, w)
    return before.sum()


def stale_field(part, values, mask, w):
    old = part.num
    aggregation.partial_absorb(part, values, mask, w)
    return old


def stale_in_loop(acc, den, updates, w):
    total = 0.0
    for u, m in updates:
        snap = acc
        ops.aio_merge_op(acc, den, u, m)
        total += snap.sum()
    return total


def stale_params(opt, params, grads, state):
    prev = params
    opt.update(params, grads, state)
    return prev
