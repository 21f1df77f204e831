"""Attention kernels: hand-written CUDA for the card, plain PyTorch
versions beside them (``ref.py``), and the device dispatch (``ops.py``)."""
