"""Plans and kernels of the gather-free SpMV pipeline."""
