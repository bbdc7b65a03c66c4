"""The demo gallery of pygraphblas_tpu_torch: one script a topic, each
with a ``main(argv=None)`` that takes ``--device`` (the CUDA card by
default) and prints ``OK`` last once its oracle agrees."""
