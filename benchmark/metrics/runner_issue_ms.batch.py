"""Host milliseconds of one `CorpusRunner.enhance_batch` call: the harness's
span around each call in the traced stretch (host clock), averaged. The
call returns once its pageable upload has been made and its kernels are
queued, so this is the host's share of a batch."""


def read(run, trace):
    d = [(b - a) * 1e-6 for n, a, b in trace.spans if n == "enhance_batch"]
    return sum(d) / len(d) if d else None
