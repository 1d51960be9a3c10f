"""Hand-written CUDA kernels for Hopper (``csrc/*.cu``), each with its plain
PyTorch version and a launch counter. CPU tensors take the plain version;
CUDA tensors launch the kernel or raise."""
