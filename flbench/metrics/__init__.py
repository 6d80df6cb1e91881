"""One reader a metric, found by the metric's name in ``BENCHMARK.json``.

``read(ctx)`` takes the run's record (``run.py`` documents its keys) and
returns the metric's value, or None where the run holds nothing for it to
read; the harness then leaves the metric out of the result line.
"""
