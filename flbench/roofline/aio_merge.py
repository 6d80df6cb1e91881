"""#8 ``aio_merge``: ``num_a += num_b``, ``den_a += den_b`` in place."""
PATTERNS = (r"\bstream_(vec4|scalar)_kernel<[^>]*\bMerge>",)
COUNTER = "aio_merge"


def cost(shape: dict, launches: int) -> tuple[float, float]:
    n = shape["N"]
    return launches * 24.0 * n, launches * 2.0 * n
