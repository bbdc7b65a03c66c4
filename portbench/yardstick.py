"""The yardstick: the card's peaks, the bytes an SpMV needs, kernel
timing by CUDA events, and the spread of a set of runs."""

import statistics
import time

import torch

# published peaks by torch.cuda.get_device_name(): NVIDIA's H100 SXM
# data sheet, dense rates, at the full 700 W power limit
PEAKS = {
    "NVIDIA H100 80GB HBM3": dict(hbm_bytes_per_s=3.35e12),
}


def peak(kind):
    """The peaks of the card named `kind`, or None where unknown."""
    return PEAKS.get(kind)


def spmv_bytes(nnz, nrows, ncols):
    """Bytes that any y = A x over A's pattern must move, whatever
    implements it: one int32 column index a stored entry, one int32 row
    pointer a row, x read once and y written once in float32.  No value
    array: PLUS_SECOND and MAX_SECOND read none."""
    return 4 * nnz + 4 * nrows + 4 * ncols + 4 * nrows


def event_ms(fn, reps):
    """Mean device ms of fn() over `reps` back-to-back calls, from CUDA
    events, after one warm-up call.  The calls are queued behind a sleep
    kernel that outlasts their enqueueing (checked: the sleep has not
    ended when the last call is queued), so the events time the card's
    work and not the host's launch path."""
    fn()
    torch.cuda.synchronize()
    cycles = 1 << 24
    while True:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        covered = not start.query()
        torch.cuda.synchronize()
        if covered:
            return start.elapsed_time(end) / reps
        if cycles >= 1 << 32:
            raise RuntimeError("event_ms: the calls were not all queued "
                               "behind the sleep; one synchronises")
        cycles *= 4


def spread(values):
    """(median, interquartile range over the median) of a set of runs,
    with Python's quartiles (``statistics.quantiles(n=4)``)."""
    med = statistics.median(values)
    q1, _, q3 = statistics.quantiles(values, n=4)
    return med, (q3 - q1) / med if med else float("inf")


class HostClock:
    """Trial times by the host's clock (a CPU run only: no card)."""

    def start(self):
        return time.perf_counter()

    def stop(self, mark):
        return (mark, time.perf_counter())

    @staticmethod
    def ms(pair):
        return (pair[1] - pair[0]) * 1e3


class EventClock:
    """Trial times by CUDA events recorded on the trial's stream before
    its first launch and after its last; ``stop`` synchronises, which
    is when the trial's result is complete on the card."""

    def start(self):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def stop(self, mark):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        torch.cuda.synchronize()
        return (mark, ev)

    @staticmethod
    def ms(pair):
        return pair[0].elapsed_time(pair[1])
