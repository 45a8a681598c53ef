"""Measurement tools of the port, each run as ``python -m malva_tpu_torch.tools.<name>``."""
