"""PyTorch/CUDA port of the Niyama serving stack.

The JAX package ``repro`` is the reference. This package imports
``torch`` and numpy only: the framework-free layers it shares with the
reference (``core/``, ``serving/replica.py``, ``serving/metrics.py``,
``models/config.py``) are copies, because importing any ``repro``
module pulls in JAX through ``repro.models``. On a CUDA device the
attention reads run through hand-written Hopper kernels
(``kernels/``, sources in ``csrc/``).
"""
