"""Utilities of the port.

The JAX package's ``utils/compile_cache.py`` (``GEOMX_COMPILE_CACHE``,
``GEOMX_COMPILE_CACHE_CPU``) has no counterpart here: it persists XLA
executables across processes, and the eager port compiles none.  Its
only compiled artifacts are the CUDA kernels, built once into
``build/torch_kernels/`` (``ops/_build.py``), which
``torch.utils.cpp_extension`` reuses while the sources are unchanged.
"""
