"""``train_job``: training steps back to back, each on a new batch of
``batch`` rows of ``seq`` + 1 uniform token ids drawn on the device from
(seed, step), so rows differ across steps."""
from __future__ import annotations

from typing import Any, Dict

from portbench.core import train

run = train.run_cell
calibrate = train.calibrate


def batch(torch, traffic: Dict[str, Any], vocab: int, seed: int, step: int,
          device):
    """Step ``step``'s batch, {'tokens': [B, S + 1]}."""
    gen = torch.Generator(device=device).manual_seed(
        (seed * 1_000_003 + 104_729 * (step + 1)) % (1 << 63))
    shape = (int(traffic['batch']), int(traffic['seq']) + 1)
    return {'tokens': torch.randint(0, vocab, shape, generator=gen,
                                    device=device)}
