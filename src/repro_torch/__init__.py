"""HeteroEdge on PyTorch + CUDA (NVIDIA Hopper).

A port of the JAX package ``repro`` beside it, module for module: the same
configs, parameter layout (dicts of L-stacked tensors), serving engine and
the paper's profile -> fit -> Eq. 4 solve -> offload loop.  The Pallas TPU
kernels on the serving path are hand-written CUDA C++ for ``sm_90a``
(``repro_torch/csrc``), built with ``nvcc`` on first use and bound with
``ctypes``.  This package never imports ``jax`` or ``repro``.
"""
