"""Kernels written by hand for Hopper (sm_90a), one directory each:
``kernel.cu`` (the CUDA source), ``ops.py`` (the wrapper: checks its
tensors, launches the kernel on CUDA tensors and counts the launches, runs
the plain version on CPU tensors) and ``ref.py`` (the plain PyTorch
version).  ``build.py`` compiles the sources with nvcc at first use."""
