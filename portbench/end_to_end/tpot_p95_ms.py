"""95th percentile over the requests finished in the window of (last
token - first token) / (tokens - 1)."""
from portbench.core.stats import percentile


def read(rec):
    if rec.get('kind') != 'serve' or not rec['tpot_s']:
        return None
    return percentile(rec['tpot_s'], 95) * 1e3
