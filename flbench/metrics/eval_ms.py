"""Milliseconds a round in the ``eval`` phase: the benchmark's wrappers
around the round loop's calls into that layer, each between two
``torch.cuda.synchronize()`` (``bench/program.PHASES``), averaged over
the traced window's rounds."""


def read(ctx):
    spans = ctx.get("spans") or {}
    if "eval" not in spans:
        return None
    return 1e3 * spans["eval"] / ctx["span_rounds"]
