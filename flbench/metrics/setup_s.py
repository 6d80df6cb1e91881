"""Seconds from the process's start to the measured window's start:
imports, CUDA start, the kernels' build or load, the data, and the
checked rounds that warm every shape up."""


def read(ctx):
    return ctx["setup_s"]
