"""Peak device memory allocated over the untraced window, GiB."""


def read(rec):
    return rec.peak_bytes / 2 ** 30 if rec.peak_bytes else None
