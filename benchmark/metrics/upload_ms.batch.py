"""Card milliseconds of host-to-card copies a batch (`mesh.shard_batch`'s
upload of the float32 batch): the profiler's HtoD copies in the traced
stretch over the batches issued in it."""


def read(run, trace):
    n = trace.delta.get("batches")
    up = sum(b - a for name, a, b in trace.copies if "HtoD" in name)
    return up * 1e-6 / n if n and up else None
