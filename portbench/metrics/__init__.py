"""Metric readers: ``<metric name>.py`` (loaded by path: names hold
dots) defines ``read(rec)``, which returns the metric's value from the
run's record (``harness.Record``) or None where the run holds nothing
to read, and may define ``probe(ctx, rec)``, which measures after the
window of a traced run.  A share of a roofline is never returned as 0."""
