"""Data parallelism over processes (counterpart of lc_tpu/parallel)."""
