"""Span tracer core: contextvar-scoped spans + cross-process context.

Own copy of ``skypilot_tpu/trace/core.py``: the same span records,
spool file names, traceparent form and env knobs. The reference's
legacy single-file timeline export (``SKYTPU_TIMELINE_FILE_PATH``) is
not ported; spans spool only under ``SKYTPU_TRACE_DIR``.

The Dapper-style timing substrate of the stack (docs/tracing.md). A
**span** is a named, attributed interval with a ``trace_id`` (shared
by every span of one logical operation, across processes), its own
``span_id`` and an optional ``parent_id``. The active span is tracked
in a :mod:`contextvars` variable, so nesting follows the call stack —
including across ``await`` points within one asyncio task — and
worker threads start clean instead of inheriting an unrelated parent.

Enablement and overhead:

- ``SKYTPU_TRACE_DIR`` set: finished spans append, one JSON line
  each, to ``spans-<component>-<pid>.jsonl`` under that directory
  (the spool ``trace.export`` merges).
- Unset: :class:`span` enters and exits on one env lookup —
  no ids, no contextvar writes, no allocation beyond the manager
  itself. Hot loops can additionally gate on :func:`enabled`.
- Set, while a ``torch.profiler`` is recording in a process that has
  loaded torch: each :class:`span` block is also a
  ``torch.profiler.record_function`` range of the same name, so the
  profile's host timeline shows it on the device trace's clock. This
  module never imports torch.

Cross-boundary propagation uses one wire form, the W3C traceparent
string ``00-<32hex trace>-<16hex span>-01``:

- process boundary: :func:`child_env` stamps it into
  ``SKYTPU_TRACE_CONTEXT`` (plus the trace knobs) for a spawned
  process; a span started with no in-process parent adopts it.
- HTTP boundary: :func:`traceparent_headers` /
  :func:`context_from_headers` carry it in the ``traceparent``
  header (serve LB -> replica ``serving_http`` -> engine).

Ids come from ``os.urandom``; with ``SKYTPU_TRACE_SEED`` (or
:func:`seed_ids`) they come from a seeded RNG so tests and golden
files are deterministic. :func:`set_clock` swaps the timestamp source
for the same reason. Dependency-free by design: this module may be
imported by logging setup and must never drag in jax, metrics or
aiohttp.
"""
from __future__ import annotations

import contextlib
import contextvars
import functools
import json
import logging
import os
import random
import re
import sys
import threading
from typing import Any, Callable, Dict, Iterator, Optional, Union

from skypilot_tpu_torch.utils import env_registry

TRACE_DIR_ENV = env_registry.SKYTPU_TRACE_DIR
TRACE_CONTEXT_ENV = env_registry.SKYTPU_TRACE_CONTEXT
TRACE_SEED_ENV = env_registry.SKYTPU_TRACE_SEED
SLOW_SPAN_ENV = env_registry.SKYTPU_TRACE_SLOW_SPAN_SECONDS

# The wire header (W3C trace-context name, lowercase per spec) and the
# request-correlation header serving_http accepts/echoes. These are
# the repo's constant registry for trace headers — reference them,
# never repeat the literals.
TRACEPARENT_HEADER = 'traceparent'
REQUEST_ID_HEADER = 'X-Request-ID'

_TRACEPARENT_RE = re.compile(
    r'\A00-([0-9a-f]{32})-([0-9a-f]{16})-[0-9a-f]{2}\Z')

_DEFAULT_SLOW_SPAN_SECONDS = 30.0

_current: contextvars.ContextVar[Optional['Span']] = \
    contextvars.ContextVar('skytpu_trace_span', default=None)

_lock = threading.Lock()
_ids_rng: Optional[random.Random] = None
_ids_rng_from_env: Optional[str] = None  # raw env value the rng came from
_component: Optional[str] = None

# Test hook (FakeClock discipline of utils/retry.py): golden exports
# need deterministic timestamps. Wall-clock by default — span times
# must merge across processes, so a monotonic-but-unanchored clock
# would not do.
import time as _time  # noqa: E402  (kept separate for set_clock)

_clock: Callable[[], float] = _time.time


def set_clock(fn: Optional[Callable[[], float]]) -> None:
    """Override the span timestamp source (tests); None restores."""
    global _clock
    _clock = fn if fn is not None else _time.time


def set_component(name: str) -> None:
    """Name this process's spool file (``spans-<name>-<pid>.jsonl``)
    and stamp every record — call once from process mains (jobs
    controller, serve controller, engine server, bench)."""
    global _component
    _component = ''.join(c if c.isalnum() or c in '._-' else '-'
                         for c in name)[:64]


def enabled() -> bool:
    """True when span records are being spooled (SKYTPU_TRACE_DIR)."""
    return bool(os.environ.get(TRACE_DIR_ENV))


# ------------------------------------------------------------------ ids
def seed_ids(seed: Optional[int]) -> None:
    """Deterministic ids from ``seed``; None restores random ids."""
    global _ids_rng, _ids_rng_from_env
    with _lock:
        _ids_rng = None if seed is None else random.Random(seed)
        # An explicit call pins the generator: env changes no longer
        # override it (None re-arms env resolution).
        _ids_rng_from_env = None if seed is None else '<explicit>'


def _rng() -> Optional[random.Random]:
    global _ids_rng, _ids_rng_from_env
    raw = os.environ.get(TRACE_SEED_ENV)
    with _lock:
        if _ids_rng_from_env == '<explicit>':
            return _ids_rng
        if raw != _ids_rng_from_env:
            _ids_rng_from_env = raw
            _ids_rng = None if raw is None else random.Random(int(raw))
        return _ids_rng


def new_trace_id() -> str:
    rng = _rng()
    if rng is not None:
        with _lock:
            return f'{rng.getrandbits(128):032x}'
    return os.urandom(16).hex()


def new_span_id() -> str:
    rng = _rng()
    if rng is not None:
        with _lock:
            return f'{rng.getrandbits(64):016x}'
    return os.urandom(8).hex()


def new_request_id() -> str:
    """A fresh X-Request-ID value (16 hex chars)."""
    return new_span_id()


# ------------------------------------------------------------- context
class SpanContext:
    """The propagatable identity of a span: (trace_id, span_id)."""

    __slots__ = ('trace_id', 'span_id')

    def __init__(self, trace_id: str, span_id: str) -> None:
        self.trace_id = trace_id
        self.span_id = span_id

    def __eq__(self, other: Any) -> bool:
        return (isinstance(other, SpanContext) and
                other.trace_id == self.trace_id and
                other.span_id == self.span_id)

    def __repr__(self) -> str:
        return f'SpanContext({self.trace_id}, {self.span_id})'


def format_traceparent(ctx: 'SpanContext') -> str:
    return f'00-{ctx.trace_id}-{ctx.span_id}-01'


def parse_traceparent(value: Optional[str]) -> Optional[SpanContext]:
    """Parse a traceparent string; malformed input -> None (a bad
    header from the outside world must degrade to a fresh trace, not
    crash the request path)."""
    if not value or not isinstance(value, str):
        return None
    m = _TRACEPARENT_RE.fullmatch(value.strip().lower())
    if m is None:
        return None
    return SpanContext(m.group(1), m.group(2))


def _env_context() -> Optional[SpanContext]:
    return parse_traceparent(os.environ.get(TRACE_CONTEXT_ENV))


def current_span() -> Optional['Span']:
    return _current.get()


def current_context() -> Optional[SpanContext]:
    """The active span's context, else the inherited env context."""
    sp = _current.get()
    if sp is not None:
        return sp.context
    return _env_context()


def current_trace_id() -> Optional[str]:
    """Trace id for log/record correlation; None when tracing is off
    (log lines must not grow a field nobody can look up)."""
    if not enabled():
        return None
    ctx = current_context()
    return ctx.trace_id if ctx is not None else None


def traceparent_headers() -> Dict[str, str]:
    """Outbound HTTP propagation: ``{traceparent: ...}`` for the
    active context, ``{}`` when tracing is off (so an upstream
    client's own header passes through proxies untouched)."""
    if not enabled():
        return {}
    ctx = current_context()
    if ctx is None:
        return {}
    return {TRACEPARENT_HEADER: format_traceparent(ctx)}


def context_from_headers(headers: Any) -> Optional[SpanContext]:
    """Parse the traceparent header out of a (case-insensitive)
    mapping; aiohttp's CIMultiDict and plain dicts both work."""
    value = None
    try:
        value = headers.get(TRACEPARENT_HEADER)
        if value is None and hasattr(headers, 'items'):
            for k, v in headers.items():
                if str(k).lower() == TRACEPARENT_HEADER:
                    value = v
                    break
    except (AttributeError, TypeError):
        return None
    return parse_traceparent(value)


def child_env(env: Optional[Dict[str, str]] = None) -> Dict[str, str]:
    """The env block a spawned process needs to continue this trace:
    ``SKYTPU_TRACE_CONTEXT`` (the active span as traceparent) plus
    the trace knobs. Updates ``env`` in place when given; always
    returns the block."""
    out: Dict[str, str] = {}
    for name in (TRACE_DIR_ENV, TRACE_SEED_ENV, SLOW_SPAN_ENV):
        val = os.environ.get(name)
        if val:
            out[name] = val
    if enabled():
        ctx = current_context()
        if ctx is not None:
            out[TRACE_CONTEXT_ENV] = format_traceparent(ctx)
    if env is not None:
        env.update(out)
    return out


# --------------------------------------------------------------- spans
class Span:
    """One timed, attributed interval. Created via :func:`start_span`
    or the :class:`span` context manager; ``finish()`` writes the
    record (when recording was on at start)."""

    __slots__ = ('name', 'trace_id', 'span_id', 'parent_id', 'attrs',
                 'start_time', 'end_time', '_recorded', '_slow_ok')

    def __init__(self, name: str, trace_id: str, span_id: str,
                 parent_id: Optional[str], attrs: Dict[str, Any],
                 recorded: bool, slow_ok: bool = False) -> None:
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.attrs = attrs
        self.start_time = _clock()
        self.end_time: Optional[float] = None
        self._recorded = recorded
        self._slow_ok = slow_ok

    @property
    def context(self) -> SpanContext:
        return SpanContext(self.trace_id, self.span_id)

    @property
    def recorded(self) -> bool:
        return self._recorded

    @property
    def duration(self) -> float:
        """Seconds from start to end (or to now while open) — the
        single timing source for metrics at instrumented sites."""
        end = self.end_time if self.end_time is not None else _clock()
        return max(0.0, end - self.start_time)

    @property
    def exemplar(self) -> Optional[str]:
        """Trace id for a metrics exemplar, None when not recorded
        (an exemplar nobody can look up is noise)."""
        return self.trace_id if self._recorded else None

    def set_attr(self, **attrs: Any) -> None:
        self.attrs.update(attrs)

    def finish(self, **attrs: Any) -> 'Span':
        if self.end_time is not None:  # idempotent
            return self
        self.end_time = _clock()
        if attrs:
            self.attrs.update(attrs)
        if self._recorded:
            _emit(self)
        return self


def start_span(name: str,
               parent: Union[Span, SpanContext, None] = None,
               slow_ok: bool = False,
               root: bool = False,
               **attrs: Any) -> Span:
    """Start a span WITHOUT activating it (explicit-parent workflows:
    the serving engine tracks per-request spans across driver-loop
    ticks where no call stack connects submit to first token).

    Parent resolution: explicit ``parent`` > active contextvar span >
    ``SKYTPU_TRACE_CONTEXT`` (cross-process). Always returns a Span —
    when tracing is disabled it is a timer-only object (no ids are
    minted, no os.urandom syscalls) whose ``duration`` still serves
    as the metric timing source, but ``finish()`` writes nothing and
    ``exemplar`` is None.

    ``slow_ok=True`` exempts the span from the slow-span warning —
    for spans that are long-lived by construction (controller
    lifetimes, cloud provisioning, bench timed sections), where 30s
    is the happy path, not an anomaly.

    ``root=True`` starts a trace of its own whatever is ambient (the
    serving engine's ticks, which belong to no request).
    """
    recorded = enabled()
    if not recorded:
        return Span(name, '', '', None, dict(attrs), False,
                    slow_ok=slow_ok)
    if parent is None and not root:
        parent = _current.get()
        if parent is None:
            parent = _env_context()
    if isinstance(parent, (Span, SpanContext)):
        trace_id, parent_id = parent.trace_id, parent.span_id
    else:
        trace_id, parent_id = new_trace_id(), None
    return Span(name, trace_id, new_span_id(), parent_id, dict(attrs),
                recorded, slow_ok=slow_ok)


@contextlib.contextmanager
def activate(sp: Optional[Span]) -> Iterator[Optional[Span]]:
    """Make ``sp`` the ambient parent for the block (child spans and
    outbound traceparent headers pick it up)."""
    if sp is None:
        yield None
        return
    token = _current.set(sp)
    try:
        yield sp
    finally:
        _current.reset(token)


class span:
    """Context manager AND decorator: time a block as a child of the
    ambient span.

        with trace.span('lb.proxy', replica=url) as sp:
            ...

        @trace.span('provisioner.bulk_provision')
        def bulk_provision(...): ...

    Disabled mode (no SKYTPU_TRACE_DIR): enter/exit are one env
    lookup and yield None — safe on warm paths. Enabled, the block is
    also a ``torch.profiler`` range while a profiler records.
    """

    __slots__ = ('_name', '_parent', '_attrs', '_slow_ok', '_root',
                 '_span', '_token', '_range')

    def __init__(self, name: str,
                 parent: Union[Span, SpanContext, None] = None,
                 slow_ok: bool = False,
                 root: bool = False,
                 **attrs: Any) -> None:
        self._name = name
        self._parent = parent
        self._slow_ok = slow_ok
        self._root = root
        self._attrs = attrs
        self._span: Optional[Span] = None
        self._token = None
        self._range = None

    def __enter__(self) -> Optional[Span]:
        if not enabled():
            return None
        self._span = start_span(self._name, parent=self._parent,
                                slow_ok=self._slow_ok, root=self._root,
                                **self._attrs)
        self._token = _current.set(self._span)
        self._range = _profiler_range(self._name)
        return self._span

    def __exit__(self, exc_type, exc, tb) -> None:
        if self._span is None:
            return
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None
        _current.reset(self._token)
        if exc_type is not None:
            self._span.set_attr(error=f'{exc_type.__name__}: {exc}')
        self._span.finish()
        self._span = None
        self._token = None

    def __call__(self, fn: Callable) -> Callable:
        name = self._name or getattr(fn, '__qualname__', fn.__name__)
        parent = self._parent
        slow_ok = self._slow_ok
        attrs = self._attrs

        root = self._root

        @functools.wraps(fn)
        def wrapper(*args: Any, **kwargs: Any):
            with span(name, parent=parent, slow_ok=slow_ok, root=root,
                      **attrs):
                return fn(*args, **kwargs)

        return wrapper


def _profiler_range(name: str) -> Any:
    """An entered ``torch.profiler.record_function`` range named
    ``name`` while a torch profiler records in this process, else None.
    Torch is looked up in ``sys.modules``, never imported: a process
    that has not loaded it has no profiler to record."""
    torch = sys.modules.get('torch')
    if torch is None or not torch.autograd._profiler_enabled():
        return None
    rf = torch.profiler.record_function(name)
    rf.__enter__()
    return rf


# ------------------------------------------------------------ emission
def _slow_threshold() -> float:
    raw = os.environ.get(SLOW_SPAN_ENV)
    if raw is None:
        return _DEFAULT_SLOW_SPAN_SECONDS
    try:
        return float(raw)
    except ValueError:
        return _DEFAULT_SLOW_SPAN_SECONDS


def spool_path(trace_dir: Optional[str] = None) -> str:
    """This process's spool file under ``trace_dir`` (default: the
    env knob)."""
    trace_dir = trace_dir or os.environ.get(TRACE_DIR_ENV) or '.'
    name = _component or 'proc'
    return os.path.join(os.path.expanduser(trace_dir),
                        f'spans-{name}-{os.getpid()}.jsonl')


def _emit(sp: Span) -> None:
    if enabled():
        record = {
            'name': sp.name,
            'trace_id': sp.trace_id,
            'span_id': sp.span_id,
            'parent_id': sp.parent_id,
            'start': sp.start_time,
            'end': sp.end_time,
            'pid': os.getpid(),
            'tid': threading.get_ident(),
            'component': _component,
            'attrs': {k: _jsonable(v) for k, v in sp.attrs.items()},
        }
        path = spool_path()
        try:
            # Open-append-close per span, like the fault-injection
            # record file: small single writes are atomic enough on
            # POSIX for concurrent processes, and a crash loses at
            # most the open span. Span volume is control-plane /
            # per-request, never per-token.
            os.makedirs(os.path.dirname(path), exist_ok=True)
            with open(path, 'a', encoding='utf-8') as f:
                f.write(json.dumps(record) + '\n')
        except OSError as e:
            # Tracing must never take down the traced path; say why
            # the trace will be missing and carry on.
            _logger().warning('trace spool write failed (%s): %s',
                              path, e)
    if sp._slow_ok:  # noqa: SLF001 — same module
        return
    threshold = _slow_threshold()
    if threshold > 0 and sp.duration >= threshold:
        _logger().warning(
            '[trace] slow span %s took %.2fs (trace=%s span=%s)',
            sp.name, sp.duration, sp.trace_id, sp.span_id)


def _jsonable(v: Any) -> Any:
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    return repr(v)


def _logger() -> logging.Logger:
    return logging.getLogger(__name__)
