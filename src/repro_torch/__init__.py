"""PlexRL in PyTorch for NVIDIA Hopper: the port of :mod:`repro` (JAX/TPU).

The layout mirrors ``repro`` module for module (``configs``, ``kernels``,
``models``, ``rl``, ``core``, ``core.scheduler``, ``launch``). This package
imports ``torch`` and never ``jax`` or anything of ``repro``; the JAX package
stays the reference the tests hold it against.
"""
