"""Seconds a round: the measured window over the whole rounds in it."""


def read(ctx):
    return ctx["window_s"] / ctx["window_rounds"]
