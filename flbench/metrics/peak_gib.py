"""The device memory peak over the measured window, in GiB
(``torch.cuda.max_memory_allocated`` after a reset at its start)."""


def read(ctx):
    return ctx["window_peak_bytes"] / 2 ** 30
