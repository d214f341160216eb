"""Attention kernels written by hand for Hopper (``csrc/``), their plain
PyTorch versions (``ref``) and the device dispatch between them (``ops``)."""
