"""The H100 serving benchmark of ``repro_torch``.

One command runs one cell once::

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The harness is driven by data.  ``BENCHMARK.json`` at the checkout's
root lists the cells and metrics; everything that belongs to one of
them is a file of its own, found by its name:

* ``bench/workloads/<cell>.json``: the configuration, the traffic mix,
  the engine's arguments, the output check's limit;
* ``bench/configs/<config>.json``: the port's config it cuts, the
  published source and sizes, what was reduced, and which plain
  reference (``bench/references/<name>.py``) computes it;
* ``bench/traffic/<mix>.json``: parameters of the one general
  generator, :mod:`h100bench.traffic`;
* ``bench/metrics/<metric>.py``: one reader per metric, ``read(run)``
  returning a number or None;
* ``bench/counts/<kernel>.py``: the operations and bytes of one kernel
  or of the model's steps.

Nothing here imports ``jax`` or the JAX package ``repro``; the program
under test is ``repro_torch``, loaded from the checkout's ``src``.
"""
