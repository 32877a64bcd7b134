"""``closed_chat``: independent single-turn requests with no shared
prefix, from closed-loop clients (``clients_per_slot`` a slot of the
engine), each submitting its next request the moment its last one
finishes. Prompt and answer lengths are drawn from the mix's
distributions once, from its ``lengths_seed``; the run's seed draws
every token id."""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np

from portbench.core import serve
from portbench.core.traffic import Turn, block_order, lengths

run = serve.run_cell
calibrate = serve.calibrate


class Generator:
    """The mix's fixed sequence of (prompt length, answer length), taken
    in turn by whichever client asks next."""

    def __init__(self, traffic: Dict[str, Any], vocab: int, seed: int):
        n = int(traffic['sequence'])
        fixed = np.random.default_rng(int(traffic['lengths_seed']))
        self.prompt_lens = lengths(traffic['prompt'], n, fixed)
        self.output_lens = lengths(traffic['output'], n, fixed)
        self.order = block_order(n, int(traffic['block']), fixed)
        self.rng = np.random.default_rng(seed)
        self.vocab = vocab
        self.i = 0

    def next(self, client: int) -> Turn:
        del client
        j = self.order[self.i % len(self.order)]
        self.i += 1
        ids = self.rng.integers(0, self.vocab, int(self.prompt_lens[j]))
        return Turn(ids.tolist(), int(self.output_lens[j]))

    def answered(self, client: int, turn: Turn, tokens: List[int]) -> None:
        del client, turn, tokens
