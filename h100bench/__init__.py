"""The benchmark of malva_tpu_torch on an NVIDIA H100 (``run.py``)."""
