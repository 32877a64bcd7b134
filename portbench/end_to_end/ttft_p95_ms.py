"""95th percentile of submit to first token (on_token's clock) over every
request submitted in the window; one still waiting at the close counts
with its wait so far."""
from portbench.core.stats import percentile


def read(rec):
    if rec.get('kind') != 'serve' or not rec['ttft_s']:
        return None
    return percentile(rec['ttft_s'], 95) * 1e3
