"""Tokens of every training step the window ran, over the time from the
window's start to the end of its last (synchronised) step."""


def read(rec):
    if rec.get('kind') != 'train':
        return None
    return rec['train_tokens'] / rec['window_s']
