"""The benchmark of the PyTorch/CUDA port `koala_tpu_torch` (see `run.py`)."""
