"""AnycostFL on PyTorch and hand-written Hopper kernels.

A port of the JAX/Pallas package ``repro`` that keeps its module names,
its parameter layouts and its numpy random streams, so that each module
here can be held against its counterpart there.  The package imports
``torch`` and numpy only; the CUDA kernels under ``kernels/csrc`` are
compiled with ``nvcc`` at their first use on a card.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
on the CPU every kernel is replaced by its plain PyTorch version.
"""
