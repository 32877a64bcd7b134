"""The comparisons that decide ``correct``: the numbers each run
compares, and each against its limit from ``limits/<cell>.json``.

Serving: once the window has closed, a sample of the finished requests
drawn from the seed, the one with the most served tokens first, until
the sample holds ``sample_tokens`` served tokens or ``sample_requests``
requests. The plain reference runs once over each prompt with its
served tokens; the number is the widest gap by which a served token's
reference logit lies below the reference's best at its position.

Training: the program's first steps (set-up drives them through the
window's own call and feed) against the reference's steps from the
same weights and batches: each step's loss, each leaf's norm of the
first gradient as the optimizer got it (worked out from the program's
Adafactor state after one step), and each leaf's norm of the change of
the parameters after the steps, each leaf by the gap between the two
norms over the larger of the reference's norm of that leaf and of the
median leaf; the worst leaf is the number. Leaves whose reference
gradient is under a thousandth of the median leaf's are left out of the
change (round-off alone moves them)."""
from __future__ import annotations

import statistics
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np

from portbench.core import model as model_lib


def serve_sample(reqs: Dict[int, Any], finished: Sequence[int], seed: int,
                 tokens: int, most: int) -> List[int]:
    """Request ids: the longest finished one, then others drawn from the
    seed until ``tokens`` served tokens or ``most`` requests."""
    if not finished:
        return []
    longest = max(finished, key=lambda r: (len(reqs[r].result.tokens), -r))
    pick, total = [longest], len(reqs[longest].result.tokens)
    rest = [r for r in sorted(finished) if r != longest]
    order = np.random.default_rng(seed % (1 << 63)).permutation(len(rest))
    for j in order:
        if total >= tokens or len(pick) >= most:
            break
        pick.append(rest[j])
        total += len(reqs[rest[j]].result.tokens)
    return pick


def serve_gap(torch, config: Dict[str, Any], weights: Dict[str, Any],
              reqs: Dict[int, Any], sample: Sequence[int], device,
              control: str = '') -> Dict[str, float]:
    """Over the sample's served tokens (or, with ``control``, the tokens
    the control model puts first): the widest gap ('widest'), its 99th
    percentile and mean, the share of tokens that are not the
    reference's first, and the largest of the requests' own mean gaps
    ('worst_request_mean')."""
    from portbench.reference import model as ref
    ref.no_tf32()
    seqs = [list(reqs[r].turn.prompt) + list(reqs[r].result.tokens)
            for r in sample]
    starts = [len(reqs[r].turn.prompt) for r in sample]
    base = ref.Model(config, weights)
    ctl = ref.Model(config, weights, control) if control else None
    g = ref.gaps(base, seqs, starts, device, ctl).double().cpu()
    per_request = g.split([len(s) - st for s, st in zip(seqs, starts)])
    return {'widest': float(g.max()), 'p99': float(g.quantile(0.99)),
            'mean': float(g.mean()), 'off_first': float((g > 0).double()
                                                        .mean()),
            'worst_request_mean': max(float(x.mean()) for x in per_request)}


def serve_numbers(gaps: Dict[str, float]) -> Dict[str, float]:
    """The numbers a serving cell's limits may compare, by their names
    in ``limits/<cell>.json``."""
    return {'widest_gap': gaps.get('widest'), 'mean_gap': gaps.get('mean'),
            'worst_request_mean_gap': gaps.get('worst_request_mean')}


def judged(numbers: Dict[str, float], limits: Dict[str, Any]
           ) -> Tuple[bool, Dict[str, Dict[str, float]]]:
    """(correct, {name: {'value', 'limit'}}): every number at or under
    its limit; a number that is missing or not finite fails."""
    out, ok = {}, True
    for name, spec in limits['numbers'].items():
        v = numbers.get(name)
        good = v is not None and bool(np.isfinite(v))
        out[name] = {'value': v if good else None, 'limit': spec['limit']}
        ok = ok and good and v <= spec['limit']
    return ok, out


# ---------------------------------------------------------------- training

def leaf_paths(tree: Dict[str, Any]) -> List[tuple]:
    return [p for p, _ in model_lib.leaves(tree)]


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def grad_norms_from_state(opt_state: Dict[str, Any], params: Dict[str, Any]
                          ) -> Dict[tuple, float]:
    """Each leaf's gradient norm after one Adafactor step from its state:
    at the first step the second moments are the gradient's squares (the
    decay is 0), factored ones as their means over the largest axis
    (``v_row``), so the sum of squares is ``v_row``'s sum times that
    axis' size; unfactored ones hold them whole (``v``)."""
    from portbench.reference.train import factored_dims
    out = {}
    for path in leaf_paths(params):
        shape = tuple(_get(params, path).shape)
        dims = factored_dims(shape)
        if dims is None:
            sq = float(_get(opt_state['v'], path).double().sum())
        else:
            sq = float(_get(opt_state['v_row'], path).double().sum()) * \
                shape[dims[1]]
        out[path] = sq ** 0.5
    return out


def change_norms(torch, config: Dict[str, Any], params: Dict[str, Any],
                 seed: int, device) -> Dict[tuple, float]:
    """Each leaf's norm of (params now - params as drawn from ``seed``),
    drawing each leaf again alone."""
    out = {}
    for i, (path, shape) in enumerate(model_lib.leaves(
            model_lib.shapes(config))):
        p0 = model_lib.draw_leaf(torch, config, path, shape, i, seed, device,
                                 dtype=_get(params, path).dtype)
        p = _get(params, path).detach()
        sq = 0.0
        for a, b in zip(p.reshape(-1).split(1 << 26),
                        p0.reshape(-1).split(1 << 26)):
            sq += float((a.double() - b.double()).pow(2).sum())
        out[path] = sq ** 0.5
        del p0
    return out


def worst_leaf(got: Dict[tuple, float], want: Dict[tuple, float],
               keep=None) -> float:
    """max over leaves of |got - want| / max(want, median of want)."""
    paths = [p for p in want if keep is None or p in keep]
    med = statistics.median(want[p] for p in paths)
    return max(abs(got[p] - want[p]) / max(want[p], med, 1e-30)
               for p in paths)


def train_numbers(prog: Dict[str, Any], ref: Dict[str, Any]
                  ) -> Dict[str, float]:
    """The compared numbers from the program's and the reference's
    readings ({'losses', 'grad_norms', 'change_norms'} each)."""
    med = statistics.median(ref['grad_norms'].values())
    moved = {p for p, g in ref['grad_norms'].items() if g >= 1e-3 * med}
    return {
        'loss_gap': max(abs(a - b) / abs(b)
                        for a, b in zip(prog['losses'], ref['losses'])),
        'grad_norm_gap': worst_leaf(prog['grad_norms'], ref['grad_norms']),
        'change_gap': worst_leaf(prog['change_norms'], ref['change_norms'],
                                 moved),
    }
