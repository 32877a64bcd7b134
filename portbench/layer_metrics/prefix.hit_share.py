"""Share (%) of the prompt tokens admitted in the window that the prefix
cache served from its pool: each request's ``reused`` count (the
engine's slot state at its first token) over its prompt length."""


def read(rec):
    if rec.get('kind') != 'serve' or not rec['prompt_tokens_admitted']:
        return None
    return 100.0 * rec['prompt_tokens_reused'] / rec['prompt_tokens_admitted']
