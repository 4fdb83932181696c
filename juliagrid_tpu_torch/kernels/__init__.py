"""Hand-written CUDA kernels for Hopper (``csrc/``), each beside its plain
PyTorch version. Sources are built with nvcc at first use (``_build``)."""
