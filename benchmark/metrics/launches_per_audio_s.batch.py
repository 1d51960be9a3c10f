"""Kernel launches on the card per second of audio enhanced: the profiler's
kernels in the traced stretch over the audio of the batches issued in it
(the engine's and the models': the harness launches none in the window)."""


def read(run, trace):
    audio = trace.delta.get("audio_s")
    return len(trace.kernels) / audio if audio and trace.kernels else None
