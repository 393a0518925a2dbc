"""Device operations (kernels, copies, memsets) a train step in the trace."""


def read(rec):
    n = len(rec.device_events())
    return n / rec.traced_iters if n and rec.traced_iters else None
