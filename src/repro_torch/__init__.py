"""PyTorch/CUDA port of the ``repro`` package (Saturn reproduction).

It mirrors ``repro``'s layout, one module for each reference module, and
imports neither JAX nor ``repro``.  Kernels that the JAX package wrote in
Pallas for the TPU are written by hand for Hopper under ``kernels/``.
"""
