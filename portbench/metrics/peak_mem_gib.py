"""The program's peak device memory over the run in GiB:
``torch.cuda.max_memory_allocated()`` read when the window closes, the
peak counted from before the program's matrix was built (the harness's
own graph generation is freed and left out)."""


def read(rec):
    return rec.peak_bytes / 2**30 if rec.peak_bytes else None
