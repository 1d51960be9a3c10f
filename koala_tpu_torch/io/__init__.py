from .wav import read_wav, write_wav, validate_wav_format

__all__ = ["read_wav", "write_wav", "validate_wav_format"]
