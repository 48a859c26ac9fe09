"""Hand-written CUDA kernels for Hopper, one subpackage each: ``ops.py``
(the checked wrapper that launches the kernel on CUDA tensors and runs
the plain version on CPU tensors), ``ref.py`` (the plain PyTorch
version) and ``csrc/`` (the CUDA source, built by ``_build``)."""
