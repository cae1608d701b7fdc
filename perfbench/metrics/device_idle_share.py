"""device_idle_share: 100 x (1 - the device's busy time over the traced
frames' untraced wall time), in percent. The busy time is the union of
the device's operations in a trace that records the device alone; the
wall time is the host clock's over the same frames rendered again
untraced, since recording every launch slows the host and so lengthens
the traced window."""


def read(run):
    t = run.trace
    if t is None or t.device_ops == 0 or not run.untraced_s:
        return None
    return 100.0 * (1.0 - t.busy_s / run.untraced_s)
