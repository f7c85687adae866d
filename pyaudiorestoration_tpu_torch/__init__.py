"""PyTorch/CUDA port of pyaudiorestoration_tpu for NVIDIA Hopper.

Mirrors the JAX package's layout (``ops``, ``models``, ``pipelines``,
``kernels``, ``utils``) so every function's counterpart is found by path.
The JAX package is the reference; this package imports ``torch`` and never
``jax`` nor anything of the JAX package (its host I/O is its own, in
``utils``).  Importing the package imports nothing.
"""
