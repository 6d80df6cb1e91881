from repro_torch.core import aggregation
from repro_torch.kernels import ops


def cloned_plane(num, den, u, m, w):
    before = num.clone()
    ops.aio_absorb_op(num, den, u, m, w)
    return before.sum(), num.sum()


def rebound_alias(part, values, mask, w):
    old = part.num
    aggregation.partial_absorb(part, values, mask, w)
    old = part.num.clone()
    return old, part.count


def read_before(acc, den, u, m):
    snap = acc
    total = snap.sum()
    ops.aio_merge_op(acc, den, u, m)
    return total


def dict_update(table, other):
    seen = table
    table.update(other)
    return seen
