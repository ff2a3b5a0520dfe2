"""One reader per metric, found by the metric's name
(``metrics/<name>.py``): ``UNIT`` and ``read(ctx)``, which returns the
value or None where the run holds nothing to read. ``_common.py`` holds
what several readers share."""
