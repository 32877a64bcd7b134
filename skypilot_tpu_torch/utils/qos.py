"""Multi-tenant QoS primitives (docs/qos.md).

Own copy of ``skypilot_tpu/utils/qos.py``: the same classes, weights,
bucket and DRR arithmetic and knobs, so both engines order the same
traffic the same way.

Pure host-side policy shared by the serving engine, the HTTP front
end and the load balancer: priority classes, the per-tenant token
bucket that rate-limits admission in tick-tokens, and the deficit-
round-robin (DRR) scheduler state that orders admission across
tenants by class weight.

Everything here is deliberately clock-explicit (``now`` is an
argument, never ``time.time()`` read inside) so the unit tests drive
the bucket and the scheduler with a fake clock, and deliberately
import-light (stdlib only) so the HTTP layer and the LB can validate
headers without pulling in the engine.

Class semantics
---------------
``interactive`` > ``standard`` > ``bulk``. Rank 0 is the most
latency-sensitive; shedding and preemption walk the ranks from the
bottom (bulk first), DRR quanta scale with the class weight so
interactive subqueues drain fastest under contention. Requests that
name no class are ``standard`` — single-class traffic therefore
degenerates to the pre-QoS FIFO bitwise (regression-tested).
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional, Tuple

from skypilot_tpu_torch.utils import env_registry

# Ordered most- to least-latency-sensitive; index = rank.
PRIORITY_CLASSES: Tuple[str, ...] = ('interactive', 'standard', 'bulk')
DEFAULT_CLASS = 'standard'
CLASS_RANK: Dict[str, int] = {
    c: i for i, c in enumerate(PRIORITY_CLASSES)}

# Request headers (body-key fallback: 'tenant' / 'priority_class').
TENANT_HEADER = 'X-Tenant-ID'
CLASS_HEADER = 'X-Priority-Class'

# Default DRR weights: interactive earns 8 tick-tokens of quantum for
# every 1 bulk earns. Overridden by SKYTPU_QOS_WEIGHTS.
DEFAULT_WEIGHTS: Dict[str, int] = {
    'interactive': 8, 'standard': 4, 'bulk': 1}

# Tenant ids become metric label values and ride in HTTP headers:
# bound the charset and length so a hostile id can neither smuggle
# header syntax nor explode label cardinality by sheer size. (Series
# cardinality itself is bounded separately via max_series.)
_TENANT_RE = re.compile(r'\A[A-Za-z0-9._-]{1,64}\Z')


def validate_tenant(value: Optional[str]) -> Optional[str]:
    """Normalized tenant id, or None for absent. Raises ValueError on
    a malformed id (HTTP maps it to a 400)."""
    if value is None or value == '':
        return None
    if not isinstance(value, str) or not _TENANT_RE.fullmatch(value):
        raise ValueError(
            f'invalid tenant id {value!r}: must match '
            '[A-Za-z0-9._-]{1,64}')
    return value


def validate_class(value: Optional[str]) -> str:
    """Normalized priority class (absent -> DEFAULT_CLASS). Raises
    ValueError on an unknown class (HTTP maps it to a 400)."""
    if value is None or value == '':
        return DEFAULT_CLASS
    if not isinstance(value, str) or \
            value.lower() not in CLASS_RANK:
        raise ValueError(
            f'invalid priority class {value!r}: expected one of '
            f'{PRIORITY_CLASSES}')
    return value.lower()


def class_rank(priority_class: Optional[str]) -> int:
    """Rank for ordering (0 = most latency-sensitive). Unknown or
    absent classes rank as DEFAULT_CLASS — ordering code never
    raises on a request that skipped validation."""
    if priority_class is None:
        return CLASS_RANK[DEFAULT_CLASS]
    return CLASS_RANK.get(priority_class, CLASS_RANK[DEFAULT_CLASS])


def parse_weights(spec: Optional[str] = None) -> Dict[str, int]:
    """DRR weights from a "interactive=8,standard=4,bulk=1" spec
    (SKYTPU_QOS_WEIGHTS when ``spec`` is None). Unknown classes and
    malformed entries raise; missing classes keep their defaults;
    weights clamp to >= 1 (a zero weight would starve the class
    forever — shedding, not weighting, is the starvation tool)."""
    if spec is None:
        spec = env_registry.get(env_registry.SKYTPU_QOS_WEIGHTS)
    weights = dict(DEFAULT_WEIGHTS)
    if not spec:
        return weights
    for part in spec.split(','):
        part = part.strip()
        if not part:
            continue
        if '=' not in part:
            raise ValueError(
                f'malformed QoS weight entry {part!r}: expected '
                'class=weight')
        cls, _, raw = part.partition('=')
        cls = cls.strip().lower()
        if cls not in CLASS_RANK:
            raise ValueError(
                f'unknown priority class {cls!r} in QoS weights: '
                f'expected one of {PRIORITY_CLASSES}')
        weights[cls] = max(1, int(raw.strip()))
    return weights


@dataclasses.dataclass
class TokenBucket:
    """Per-tenant admission budget in tick-tokens.

    ``rate`` tokens/second refill up to ``burst`` capacity; a
    request spends its admission charge (max_new + prefill ticks *
    decode_chunk — the engine's existing cost model) when it is
    actually admitted. ``peek`` answers "could this charge be spent
    NOW" without spending, so the DRR scan can skip a broke tenant
    and admit the next one instead of head-blocking.

    Clock-explicit: callers pass ``now`` (monotonic seconds). Buckets
    start FULL — a fresh tenant gets its burst, which is what makes
    the bucket a rate limiter rather than a slow-start penalty.
    """
    rate: float
    burst: float
    tokens: float = dataclasses.field(default=-1.0)
    updated: float = dataclasses.field(default=0.0)

    def __post_init__(self) -> None:
        if self.tokens < 0:
            self.tokens = self.burst

    def _refill(self, now: float) -> None:
        if now > self.updated:
            self.tokens = min(
                self.burst,
                self.tokens + (now - self.updated) * self.rate)
        self.updated = max(self.updated, now)

    def peek(self, charge: float, now: float) -> bool:
        self._refill(now)
        return self.tokens >= charge

    def spend(self, charge: float, now: float) -> bool:
        self._refill(now)
        if self.tokens < charge:
            return False
        self.tokens -= charge
        return True


class DeficitRoundRobin:
    """Weighted-fair ordering over per-tenant subqueues (DRR,
    Shreedhar & Varghese 1996), priced in tick-tokens.

    Each (tenant, class) stream owns a deficit counter. Each round
    the active streams earn ``quantum * weight[class]`` deficit; a
    stream whose head's charge fits its deficit may admit it (the
    charge is then deducted). The scheduler only ORDERS — the engine
    still admits only into a free slot under its prefill-row cap, and
    runs the token buckets independently; a stream left waiting keeps
    its deficit for the next tick.

    State is keyed by ``(tenant, class)`` so one tenant submitting
    both interactive and bulk work competes as two streams, each at
    its class's weight. Empty streams forfeit their deficit (classic
    DRR: an idle flow must not bank credit), which `prune` enforces.
    """

    def __init__(self, weights: Optional[Dict[str, int]] = None,
                 quantum: float = 1.0) -> None:
        self.weights = dict(weights or DEFAULT_WEIGHTS)
        self.quantum = float(quantum)
        self._deficit: Dict[Tuple[Optional[str], str], float] = {}
        # Round-robin cursor: streams are visited in a stable rotation
        # so equal-weight tenants alternate instead of one winning
        # every tie.
        self._ring: List[Tuple[Optional[str], str]] = []

    def _weight(self, cls: str) -> int:
        return max(1, self.weights.get(cls,
                                       DEFAULT_WEIGHTS[DEFAULT_CLASS]))

    def earn(self, streams: List[Tuple[Optional[str], str]]) -> None:
        """Start a round: every live stream earns its quantum, dead
        streams (not in ``streams``) forfeit their state."""
        live = set(streams)
        for key in list(self._deficit):
            if key not in live:
                del self._deficit[key]
        self._ring = [k for k in self._ring if k in live]
        for key in streams:
            if key not in self._deficit:
                self._deficit[key] = 0.0
                self._ring.append(key)
            self._deficit[key] += self.quantum * self._weight(key[1])

    def order(self) -> List[Tuple[Optional[str], str]]:
        """Streams in service order for this round: by class rank
        first (interactive before bulk at any deficit), then by the
        rotation cursor within a rank."""
        return sorted(self._ring,
                      key=lambda k: class_rank(k[1]))

    def can_spend(self, key: Tuple[Optional[str], str],
                  charge: float) -> bool:
        return self._deficit.get(key, 0.0) >= charge

    def spend(self, key: Tuple[Optional[str], str],
              charge: float) -> None:
        self._deficit[key] = self._deficit.get(key, 0.0) - charge
        # Move the served stream to the back of its rotation so
        # equal-rank streams take turns across rounds.
        if key in self._ring:
            self._ring.remove(key)
            self._ring.append(key)

    def prune(self) -> None:
        """Forget every stream (end of contention): deficits must not
        survive an idle period as banked credit."""
        self._deficit.clear()
        self._ring.clear()


def qos_config_from_env() -> Dict[str, float]:
    """Engine QoS knobs resolved once at construction (the same
    discipline as the decode-dispatch knobs): rate/burst for the
    per-tenant buckets, the queue-pressure bound, and the preemption
    threshold. All default off."""
    rate = float(env_registry.get(
        env_registry.SKYTPU_QOS_TENANT_RATE, '0') or '0')
    burst_raw = env_registry.get(env_registry.SKYTPU_QOS_TENANT_BURST)
    burst = float(burst_raw) if burst_raw else 4.0 * rate
    return {
        'tenant_rate': rate,
        'tenant_burst': burst,
        'max_queue': int(env_registry.get(
            env_registry.SKYTPU_QOS_MAX_QUEUE, '0') or '0'),
        'preempt_after_s': float(env_registry.get(
            env_registry.SKYTPU_QOS_PREEMPT_AFTER_S, '0') or '0'),
        'disable': env_registry.get(
            env_registry.SKYTPU_QOS_DISABLE, '0') == '1',
    }
