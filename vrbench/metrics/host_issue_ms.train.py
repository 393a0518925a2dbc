"""Mean host ms from calling the train step until it returns, before any
synchronise, over the untraced window."""


def read(rec):
    return rec.mean_issue_ms()
