"""The entry points the benchmark drives, one module each, found by the
``entry`` name of a workload: ``run(cell)`` sets up the program, runs
the measured window and returns the outcome (see ``lib/cell.py``)."""
