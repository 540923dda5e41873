"""Data parallelism over processes (counterpart of dreamfusion_tpu/parallel)."""
