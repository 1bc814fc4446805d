"""Per-layer metric readers, one file per metric or per metric stem
(``device_idle_pct.py`` serves ``device_idle_pct.offline``, ``.online``
and ``.train``), each with ``read(run, name)``: the value, or None where
the run left nothing to read (the harness then leaves the metric out).
"""
