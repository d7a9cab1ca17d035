"""PyTorch / CUDA port of the RoundPipe reproduction, for NVIDIA Hopper.

Laid out like the JAX package ``repro`` (``models/``, ``kernels/``,
``launch/``, ``configs/``), which stays the reference the port is held
against. The port imports ``torch`` and nothing of JAX or of ``repro``.
"""
