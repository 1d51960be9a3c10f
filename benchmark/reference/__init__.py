"""Plain references of the model kinds: one module a kind, named after it.

Each kind's module has `enhance(...)` over whole fresh streams, in plain
PyTorch, and imports nothing of the program. `stft.py` holds the engine's
transform and the rounding rules, `pv.py` and `wav.py` the readers of the
model files and the audio.
"""
