"""Process start to the first timed request or step: imports, weights
drawn on the card, the kernel build, warm-up and tick capture (training:
the steps before the window, less the time spent reading what the check
compares)."""


def read(rec):
    return rec['setup_s']
