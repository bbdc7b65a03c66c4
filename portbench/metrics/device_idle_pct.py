"""The share of the traced segment in which no operation ran on the
card (the union of its kernels', copies' and sets' intervals on the
profiler's timeline), in %.  Events the profiler drops read as idle:
the run prints each kernel's events against its launches."""


def read(rec):
    t = rec.trace
    if not t or t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * (t["window_s"] - t["busy_s"]) / t["window_s"]
