"""The GAP benchmark drivers of pygraphblas_tpu_torch (``prmark``,
``bcmark``): each a ``main(argv=None)`` and a ``run(args)`` that returns
the last round's result."""
