"""Plain PyTorch references for the trials: the same semantics as the
program's entry points, written from their definitions.  They take only
the benchmark's own edge lists and import nothing of either package."""
