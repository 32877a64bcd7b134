"""Share (%) of the profiled slice in which no operation ran on the card
(1 - union of device operation intervals / slice), serving cells."""


def read(rec):
    s = rec.get('slice')
    if rec.get('kind') != 'serve' or not s or not s['window_s']:
        return None
    return 100.0 * (1 - s['busy_s'] / s['window_s'])
