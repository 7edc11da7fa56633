"""Process-level helpers of the port: the kernel build cache, and the
executor's host, port, shell and localization helpers."""
