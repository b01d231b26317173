"""Operators with kernels written by hand for Hopper (``csrc/``), each
beside its plain PyTorch version."""
