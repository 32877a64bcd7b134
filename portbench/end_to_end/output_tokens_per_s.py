"""Every output token emitted in the window over the window: from its
start to the end of the first engine step that ran past ``--seconds``."""


def read(rec):
    if rec.get('kind') != 'serve':
        return None
    return rec['output_tokens'] / rec['window_s']
