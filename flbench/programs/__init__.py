"""The programs a configuration can name (``"program"`` in its file), one
module each, which ``run.py`` imports by that name.

A program module provides:

* ``build(config, traffic, cell, seed, device)``: the system under test
  from the seed, with ``checked()`` (the checked rounds of set-up, which
  warm every shape up and capture what the comparison reads),
  ``round()`` (one measured round), ``timed_hooks()`` (a context for the
  traced window, or None), ``profiled(trace_mod, n)`` (``n`` more rounds
  under the profiler: the ``ctx`` entries the per-layer readers take),
  ``release()`` (the capture, with the program's state dropped) and,
  where it holds what must be given back (a process group, patches),
  ``close()``, which ``run.py`` calls once set-up and the window are
  over or have failed;
* ``follow(config, traffic, cell, seed, device, capture)``: the plain
  reference's numbers for ``bench/check.judge``, run once the program is
  freed.
"""
