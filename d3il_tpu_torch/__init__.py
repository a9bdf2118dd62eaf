"""d3il_tpu_torch: the PyTorch / CUDA port of d3il_tpu for NVIDIA Hopper.

Mirrors the JAX package's module paths and function names. This slice
holds the batched pushing env step under full arm dynamics: the Panda
chains, the scene and narrow phase, the contact cone QP, the arm dynamics
and the cartesian IK window, with the three kernels of that window written
by hand in CUDA C++ for sm_90a (``csrc/``). Imports torch and NumPy only.
Entry points run on the CUDA device unless the caller names another.
"""

__version__ = "0.1.0"
