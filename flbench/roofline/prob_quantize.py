"""#4 ``prob_quantize``: Eq. 3-4 on a masked update (reads values, mask
and uniforms; writes values and int32 levels)."""
PATTERNS = (r"\bquantize_(vec4|scalar)_kernel\b",)
COUNTER = "prob_quantize"


def cost(shape: dict, launches: int) -> tuple[float, float]:
    n = shape["N"]
    return launches * 20.0 * n, launches * 12.0 * n
