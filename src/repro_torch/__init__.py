"""PyTorch/CUDA port of the ``repro`` package for one NVIDIA H100.

Module paths mirror ``src/repro/``. This package imports ``torch`` and numpy,
never JAX and nothing of ``repro``. Serving slice: paged continuous-batching
serving of GQA text archs, with the hand-written CUDA kernels for RMSNorm
(K7), paged decode attention (K9) and paged KV append (K10).
"""
