"""Share of its roofline that the LSTM kernel (`csrc/lstm.cu`) reaches in a
batch cell: the least time of every layer-step of every hop of the batches
issued in the traced stretch (`counts.<kind>.lstm_s` at the batch's B
streams and hops, once a batch) over the card time of the kernels named
`lstm_cell_kernel`. A kind without an LSTM gives nothing."""


def read(run, trace):
    n = trace.delta.get("batches")
    lstm_s = getattr(run.counts, "lstm_s", None)
    t = trace.kernel_s(lambda k: "lstm_cell_kernel" in k)
    if not n or not t or lstm_s is None:
        return None
    return 100.0 * n * lstm_s(run.config["model"], run.batch_rows, run.hops) / t
