"""device_ops_per_ksample: device operations (kernels, copies, sets) the
profiler saw over the traced frames, per 1,000 camera samples."""


def read(run):
    t = run.trace
    if t is None or t.device_ops == 0 or not t.samples:
        return None
    return t.device_ops / (t.samples / 1000.0)
