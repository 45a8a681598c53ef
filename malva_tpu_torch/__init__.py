"""PyTorch/CUDA port of malva_tpu: the device main path on an NVIDIA H100."""
