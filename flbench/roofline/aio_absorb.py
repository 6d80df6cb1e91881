"""#7 ``aio_absorb``: ``num += w*m*u``, ``den += w*m`` in place, one
launch an update.  An edge folds a cell's updates into one accumulator,
so the fold reads each update and mask once (8 bytes an element a
launch) and the accumulator's two planes once in and once out (16 bytes
an element a fold, ``shape["folds"]`` of them); between its launches
the accumulator stays in the 50 MB L2, and counting its 16 bytes again
at every launch would put the bound above the time the kernels take."""
PATTERNS = (r"\bstream_(vec4|scalar)_kernel<[^>]*\bAbsorb>",)
COUNTER = "aio_absorb"


def cost(shape: dict, launches: int) -> tuple[float, float]:
    n = shape["N"]
    return (launches * 8.0 * n + shape.get("folds", 1) * 16.0 * n,
            launches * 4.0 * n)
