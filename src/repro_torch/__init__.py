"""repro_torch: the PyTorch/CUDA port of the SCALPEL3 reproduction.

It mirrors ``repro`` (the JAX reference) module for module: ``core`` (tables,
bitsets, flattening, extraction, cohorts), ``data`` (synthetic stars),
``study`` (plans, optimizer, executor, Study) and ``kernels`` (the CUDA C++
kernels for Hopper in ``csrc/`` and their plain PyTorch versions).  It
imports torch and numpy, never jax and nothing of ``repro``.  Entry points
run on CUDA unless the caller passes ``device="cpu"``.
"""
