"""Attention kernels: CUDA sources (``csrc/``), their wrappers, plain versions and entries."""
