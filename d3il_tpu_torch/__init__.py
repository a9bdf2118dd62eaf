"""d3il_tpu_torch: the PyTorch / CUDA port of d3il_tpu for NVIDIA Hopper.

Mirrors the JAX package's module paths and function names. It holds seven
of the eight tasks (avoiding, pushing, aligning, sorting with 2, 4 and 6
boxes, stacking) end to end on the batched substep window, in both modes,
with the bc and gmm agents, their evaluation sims and the entry scripts;
the four TPU kernels (the IK window, the arm stage, the contact phase and
the feedforward) are written by hand in CUDA C++ for sm_90a (``csrc/``).
Imports torch and NumPy only.
Entry points run on the CUDA device unless the caller names another.
"""

__version__ = "0.1.0"
