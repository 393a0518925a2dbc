"""Device idle share of the traced train steps: 100 x (1 - the union of
device-activity intervals / the traced window), from the profiler trace."""


def read(rec):
    if rec.traced_s <= 0 or not rec.device_events():
        return None
    return 100.0 * (1.0 - rec.busy_s() / rec.traced_s)
