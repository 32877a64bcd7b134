"""The traced slice of a window: ``torch.profiler`` on the device and the
host, reduced to device busy time, kernel time by name and the idle gaps
by what the host was doing.

The trace is exported as Chrome JSON into ``TMPDIR`` (the run's own),
read back and deleted. Device operations are the events of category
'kernel', 'gpu_memcpy' and 'gpu_memset' (kernels replayed from a CUDA
graph included). The harness marks its own host spans with
``record_function`` names starting 'portbench.'."""
from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile
import time
from typing import Any, Dict, List, Tuple

DEVICE_CATS = ('kernel', 'gpu_memcpy', 'gpu_memset')
TOP = 10
# Characters of a kernel's name kept in the breakdown (template arguments
# make some thousands long).
NAME = 160


def union_seconds(intervals: List[Tuple[float, float]]) -> float:
    """Seconds covered by the union of (start, end) intervals in us."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e6


def reduce_trace(events: List[Dict[str, Any]]) -> Dict[str, Any]:
    """{'busy_s', 'kernels': {name: [seconds, count]}, 'device_ops',
    'idle_gaps'} from Chrome trace events."""
    dev, host = [], []
    for e in events:
        if e.get('ph') != 'X' or 'dur' not in e:
            continue
        if e.get('cat') in DEVICE_CATS:
            dev.append(e)
        elif e.get('cat') in ('cpu_op', 'user_annotation', 'cuda_runtime',
                              'python_function'):
            host.append(e)
    intervals = [(float(e['ts']), float(e['ts']) + float(e['dur']))
                 for e in dev]
    kernels: Dict[str, List[float]] = {}
    for e in dev:
        k = kernels.setdefault(e['name'], [0.0, 0])
        k[0] += float(e['dur']) / 1e6
        k[1] += 1
    # Idle gaps between device operations, each named by the innermost
    # host event that covers its middle (the harness's span name first).
    gaps = []
    ends = sorted(intervals)
    reach = None
    for s, e in ends:
        if reach is not None and s > reach:
            gaps.append((reach, s))
        reach = e if reach is None else max(reach, e)
    spans = [e for e in host if e['name'].startswith('portbench.')]
    host.sort(key=lambda e: float(e['ts']))
    starts = [float(e['ts']) for e in host]
    named = []
    for g0, g1 in sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]:
        mid = (g0 + g1) / 2
        outer = [e['name'] for e in spans
                 if float(e['ts']) <= mid <= float(e['ts']) + float(e['dur'])]
        i = bisect.bisect_right(starts, mid)
        cover = [e for e in host[max(0, i - 2000):i]
                 if mid <= float(e['ts']) + float(e['dur']) and
                 not e['name'].startswith('portbench.')]
        inner = min(cover, key=lambda e: float(e['dur']))['name'] \
            if cover else 'no host operation'
        label = (outer[0] + ' / ' if outer else '') + inner
        named.append([label, (g1 - g0) / 1e6])
    device_ops = sorted(([n[:NAME], v[0]] for n, v in kernels.items()),
                        key=lambda t: -t[1])[:TOP]
    return {'busy_s': union_seconds(intervals), 'kernels': kernels,
            'device_ops': device_ops, 'idle_gaps': named[:TOP]}


class Slice:
    """Profile the host and the device between ``start()`` and
    ``stop()``; both synchronise the device first, so the slice holds
    whole ticks or steps and every kernel they launched."""

    def __init__(self, torch, device):
        self.torch = torch
        self.cuda = device.type == 'cuda'
        self.prof = None
        self.t0 = self.t1 = 0.0
        self.result: Dict[str, Any] = {}

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        self._sync()
        acts = [ProfilerActivity.CPU]
        if self.cuda:
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.start()
        self.t0 = time.perf_counter()

    def _sync(self) -> None:
        if self.cuda:
            self.torch.cuda.synchronize()

    def stop(self) -> Dict[str, Any]:
        self._sync()
        self.t1 = time.perf_counter()
        self.prof.stop()
        fd, path = tempfile.mkstemp(suffix='.json', prefix='portbench_trace_')
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path, encoding='utf-8') as f:
                events = json.load(f).get('traceEvents', [])
        finally:
            os.unlink(path)
        self.prof = None
        self.result = reduce_trace(events)
        self.result['window_s'] = self.t1 - self.t0
        return self.result


def span(torch, name: str, on: bool):
    """A host span the trace shows (``record_function``) when tracing."""
    if not on:
        return contextlib.nullcontext()
    return torch.profiler.record_function(name)
