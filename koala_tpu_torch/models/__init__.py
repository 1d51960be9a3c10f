from . import params_io
from .registry import MODEL_REGISTRY, get_model

__all__ = ["params_io", "get_model", "MODEL_REGISTRY"]
