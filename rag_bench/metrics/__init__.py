"""One reader a metric, found by the metric's name: ``<name>.py``, or for a
name split by a suffix (``sched_share.online``) the reader of its base name
(``sched_share.py``).  ``read(ctx)`` returns the number, or None where the
run holds nothing to read (the harness then leaves the metric out).  The
context is ``harness.readings.Context``."""
