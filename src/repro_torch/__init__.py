"""repro_torch — the PyTorch/CUDA port of Poisson sampling over acyclic
joins, for one NVIDIA Hopper card.

It mirrors the layout of the JAX package ``repro`` (``config``, ``core/``,
``kernels/``, ``engine/``) and keeps its module and function names. It
imports torch and numpy only: never jax, never ``repro``. Entry points run
on the card unless the caller passes ``device='cpu'``, where every kernel
wrapper runs its plain PyTorch version.
"""
