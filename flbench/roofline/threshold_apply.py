"""#3 ``threshold_apply``: zero the kernels below the threshold (reads the
update and the norms; writes the masked update and the keep flags)."""
PATTERNS = (r"\bthreshold_(vec4|scalar)_kernel\b",)
COUNTER = "threshold_apply"


def cost(shape: dict, launches: int) -> tuple[float, float]:
    n, k = shape["N"], shape["K"]
    return launches * (8.0 * n + 8.0 * k), launches * 1.0 * n
