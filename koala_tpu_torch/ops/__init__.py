from . import stft
from .stft import analysis_window, frame_signal, istft_frame, overlap_add, stft_frame

__all__ = ["stft", "analysis_window", "frame_signal", "istft_frame", "overlap_add",
           "stft_frame"]
