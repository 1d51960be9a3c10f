from . import mask_gru, params_io
from .registry import MODEL_REGISTRY, get_model

__all__ = ["mask_gru", "params_io", "get_model", "MODEL_REGISTRY"]
