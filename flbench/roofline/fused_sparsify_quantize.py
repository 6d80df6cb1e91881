"""#5 ``fused_sparsify_quantize``: Eq. 2-4 in one pass (reads the update,
its uniforms and the K norms; writes values and int32 levels; about 12
operations an element)."""
PATTERNS = (r"\bfused_(vec4|scalar)_kernel\b",)
COUNTER = "fused_sparsify_quantize"


def cost(shape: dict, launches: int) -> tuple[float, float]:
    n, k = shape["N"], shape["K"]
    return launches * (16.0 * n + 4.0 * k), launches * 12.0 * n
