"""The benchmark of spinrelax_tpu_torch on one NVIDIA H100 (``run.py``)."""
