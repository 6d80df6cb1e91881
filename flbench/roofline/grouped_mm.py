"""The routed experts' grouped bf16 GEMMs (``kernels/grouped_mm.py``:
PyTorch's CUTLASS grouped GEMM for Hopper and the small launch that lays
out its groups from the offsets).  The program counts, over its launches,
the multiply-adds (``grouped_mm_macs``) and the elements each product
reads once and writes once (``grouped_mm_elems``: ``M k + G k n + M
n``); the operations are two a multiply-add, the bytes two an element
(bf16).  Held against the bf16 peak, not the float32 one of
``roofline.bound_s``."""
PATTERNS = (r"prepare_grouped_gemm_data", r"GroupProblemShape")
COUNTER = "grouped_mm"


def cost(counters: dict) -> tuple[float, float]:
    """(bytes, operations) of the launches the counters add up."""
    return (2.0 * counters.get("grouped_mm_elems", 0),
            2.0 * counters.get("grouped_mm_macs", 0))
