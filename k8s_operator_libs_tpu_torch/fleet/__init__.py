"""Fleet-level hardware profiles for the PyTorch/CUDA port."""
