"""What the traffic kinds (``portbench/traffic_kinds/<kind>.py``) share:
seeded length draws, a fixed order, and the request a generator hands a
closed-loop client.

Lengths and their order come from the file alone (its ``lengths_seed``:
drawn, then permuted inside each block of ``block`` requests), so every
run seed serves the same sizes in the same order; the run's seed draws
every token id (and the weights). A closed-loop client takes the next
request from one shared sequence the moment its previous one finishes,
so the sizes served follow that sequence whatever the completion order.
(With the order drawn from the run's seed, runs of one seed agreed to
0.4% and runs of different seeds spread by 16% in the 95th percentile
of time to first token: the order moved the engine's region drains.)"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List

import numpy as np


def lengths(spec: Dict[str, Any], n: int, rng: np.random.Generator
            ) -> np.ndarray:
    """``n`` integer lengths from ``spec``: 'lognormal' (median, sigma)
    or 'uniform' (min..max inclusive), clipped to [min, max]."""
    lo, hi = int(spec['min']), int(spec['max'])
    if spec['dist'] == 'lognormal':
        x = rng.lognormal(np.log(spec['median']), spec['sigma'], n)
        return np.clip(np.rint(x), lo, hi).astype(np.int64)
    if spec['dist'] == 'uniform':
        return rng.integers(lo, hi + 1, n)
    raise ValueError(f"unknown length distribution {spec['dist']!r}")


def block_order(n: int, block: int, rng: np.random.Generator) -> np.ndarray:
    order = np.arange(n)
    for i in range(0, n, block):
        order[i:i + block] = rng.permutation(order[i:i + block])
    return order


@dataclasses.dataclass
class Turn:
    """One request: the prompt's ids and the tokens asked for."""
    prompt: List[int]
    max_new: int
