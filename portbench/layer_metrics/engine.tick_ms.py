"""Milliseconds an engine tick takes: the window's time outside the
profiled slice over the ``step()`` calls made there (the harness's own
span around each ``step()``)."""


def read(rec):
    if rec.get('kind') != 'serve' or 'unsliced' not in rec:
        return None
    u = rec['unsliced']
    return u['seconds'] / u['ticks'] * 1e3 if u['ticks'] else None
