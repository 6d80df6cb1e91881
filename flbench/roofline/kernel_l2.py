"""#1/#2 ``kernel_l2``: per-kernel L2 norms of a flat update (reads N,
writes K norms; a square and an add an element, a root a kernel)."""
PATTERNS = (r"\btile_sumsq_kernel\b", r"\bcombine_kernel\b")
COUNTER = "kernel_l2"


def cost(shape: dict, launches: int) -> tuple[float, float]:
    n, k = shape["N"], shape["K"]
    return launches * (4.0 * n + 4.0 * k), launches * (2.0 * n + k)
