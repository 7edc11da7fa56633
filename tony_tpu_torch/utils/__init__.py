"""Process-level helpers of the port: the kernel build cache."""
