"""Version of the PyTorch/CUDA port. Same major as the JAX package to
signal the same v3 streaming contract."""

__version__ = "3.0.0-torch.1"
