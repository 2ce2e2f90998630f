"""repro_torch: the FINN MVU reproduction ported to PyTorch and CUDA (Hopper).

The package mirrors ``src/repro/``'s layout module for module and is held
bit for bit against it.  It imports torch and numpy only: nothing of JAX
and nothing of the JAX package.  Kernels are built from
``kernels/csrc/`` at their first use on the card, never at import time.
"""
