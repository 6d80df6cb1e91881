"""#6 ``aio_aggregate``: Eq. 5 over an (I, N) stack of updates and masks
(reads both stacks and I weights, writes N; four operations an element
of the stack and a divide an output), each launch at its own (I, N)."""
PATTERNS = (r"\baio_kernel\b",)
COUNTER = "aio_aggregate"


def cost(shape: dict, launches: int) -> tuple[float, float]:
    stacks = shape["agg"][-launches:]
    return (sum(8.0 * i * n + 4.0 * i + 4.0 * n for i, n in stacks),
            sum(4.0 * i * n + n for i, n in stacks))
