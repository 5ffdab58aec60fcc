"""The traced window: the benchmark's spans around the program's layers,
the profiler over the window, and the records the per-layer readers take.

Spans are ``torch.profiler.record_function`` ranges named ``pb.<layer>``,
put around the program's callables at run time (``Spans.wrap``); nothing
in the program is edited. ``profile(fn)`` runs ``fn`` under the profiler
(CPU and CUDA activities) inside the span ``pb.window`` and returns a
``Trace``: the device's kernels and copies, the host's CUDA runtime calls
and the spans, each as (name, start us, end us, correlation id, linked
id); the profiler's own event objects are dropped.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import functools
import statistics

SYNCS = ("cudaStreamSynchronize", "cudaEventSynchronize",
         "cudaDeviceSynchronize", "cudaMemcpy", "cudaMemcpy2D",
         "cuStreamSynchronize", "cuEventSynchronize", "cuCtxSynchronize")
WINDOW = "pb.window"


class Spans:
    """Wraps callables in ``pb.<name>`` spans; ``restore`` undoes it."""

    def __init__(self):
        self._undo = []

    @staticmethod
    def span(name: str):
        from torch.profiler import record_function

        return record_function(f"pb.{name}")

    def wrap(self, owner, attr: str, name: str) -> None:
        """Replace ``owner.attr`` by the same callable inside a span."""
        fn = getattr(owner, attr)

        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            with self.span(name):
                return fn(*args, **kwargs)

        self._undo.append((owner, attr, owner.__dict__.get(attr, None), fn))
        setattr(owner, attr, spanned)

    def restore(self) -> None:
        for owner, attr, own, _ in reversed(self._undo):
            if own is None:
                delattr(owner, attr)
            else:
                setattr(owner, attr, own)
        self._undo.clear()


class Trace:
    """What one profiled window recorded, in microseconds."""

    def __init__(self, kernels, copies, runtime, spans):
        self.kernels = kernels  # (name, start, end, corr, linked)
        self.copies = copies  # memcpy / memset on the device
        self.runtime = runtime  # host CUDA API calls
        self.spans = spans  # (name, start, end)
        win = [s for s in spans if s[0] == WINDOW]
        self.t0, self.t1 = (win[0][1], win[0][2]) if win else (0.0, 0.0)

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    def device_intervals(self) -> list:
        """Merged intervals in which a kernel or a copy ran, clipped to the
        window."""
        ivs = sorted((max(s, self.t0), min(e, self.t1))
                     for _, s, e, *_ in self.kernels + self.copies
                     if e > self.t0 and s < self.t1)
        merged = []
        for s, e in ivs:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.device_intervals()) * 1e-6

    def span_us(self, *names: str) -> float:
        """Summed host time of the spans ``pb.<name>``."""
        want = {f"pb.{n}" for n in names}
        return sum(e - s for n, s, e in self.spans if n in want)

    def syncs(self) -> int:
        return sum(1 for r in self.runtime if r[0] in SYNCS)

    def kernels_launched_in(self, *names: str) -> list:
        """Kernels whose launch (the host's runtime call, matched by the
        profiler's correlation id) lies inside a span ``pb.<name>``."""
        want = {f"pb.{n}" for n in names}
        ivs = sorted((s, e) for n, s, e in self.spans if n in want)
        starts = [s for s, _ in ivs]

        def inside(t):
            i = bisect.bisect_right(starts, t) - 1
            return i >= 0 and t <= ivs[i][1]

        launched = {r[3] for r in self.runtime if inside(r[1])}
        by_corr = [k for k in self.kernels if k[3] in launched]
        if by_corr or not self.kernels:
            return by_corr
        launched = {r[4] for r in self.runtime if inside(r[1])}
        return [k for k in self.kernels if k[4] in launched]

    def breakdown(self) -> dict:
        """The device operations that took most time, and the longest idle
        gaps of the device summed by the span open on the host."""
        by_name = collections.Counter()
        for name, s, e, *_ in self.kernels + self.copies:
            by_name[name] += (e - s) * 1e-6
        gaps = collections.Counter()
        ivs = self.device_intervals()
        edges = [self.t0] + [x for iv in ivs for x in iv] + [self.t1]
        holes = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
        # sweep: the innermost span open at each hole's start labels it
        marks = sorted([(s, 1, i) for i, (_, s, _) in enumerate(self.spans)]
                       + [(e, 0, i) for i, (_, _, e) in enumerate(self.spans)])
        stack, j = [], 0
        for a, b in holes:
            while j < len(marks) and marks[j][0] <= a:
                _, is_start, i = marks[j]
                if is_start:
                    stack.append(i)
                elif i in stack:
                    stack.remove(i)
                j += 1
            label = self.spans[stack[-1]][0] if stack else "outside spans"
            gaps[label] += (b - a) * 1e-6
        return dict(device_ops=[[short(n), t]
                                for n, t in by_name.most_common(10)],
                    idle_gaps=[[n, t] for n, t in gaps.most_common(10)])


def short(name: str, width: int = 120) -> str:
    """A kernel's name cut to ``width`` characters for the breakdown."""
    return name if len(name) <= width else name[:width - 3] + "..."


def profile(fn):
    """Run ``fn()`` under the profiler inside ``pb.window``: (fn's result,
    Trace)."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with torch_profile(activities=acts) as prof:
        with Spans.span("window"):
            out = fn()
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    return out, extract(prof)


COPIES = ("Memcpy", "Memset")


def extract(prof) -> Trace:
    """The profiler's events as records. Device events are kernels, or
    copies where their name says so (``Memcpy ...``, ``Memset ...``); the
    device's mirror of a span (named ``pb.*``) is left out. Host events
    are CUDA runtime or driver calls (``cuda*``, ``cu[A-Z]*``) or the
    benchmark's spans (``pb.*``)."""
    from torch.autograd import DeviceType

    kernels, copies, runtime, spans = [], [], [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        s = e.start_ns() * 1e-3
        rec = (name, s, s + e.duration_ns() * 1e-3, e.correlation_id(),
               e.linked_correlation_id())
        if e.device_type() == DeviceType.CUDA:
            if name.startswith(COPIES):
                copies.append(rec)
            elif not name.startswith("pb."):
                kernels.append(rec)
        elif name.startswith("pb."):
            spans.append(rec[:3])
        elif name.startswith("cuda") or (name.startswith("cu")
                                         and name[2:3].isupper()):
            runtime.append(rec)
    return Trace(kernels, copies, runtime, spans)


class Context:
    """What a per-layer reader gets: the trace, the units (scans)
    of the traced window, ``work`` (``work/``'s count of one unit) and the
    loop's own records (``stats``)."""

    def __init__(self, trace: Trace, units: int, work: dict,
                 stats: dict | None = None):
        self.trace, self.units, self.work = trace, units, work
        self.stats = stats or {}

    @property
    def window_s(self) -> float:
        return self.trace.window_s

    @property
    def busy_s(self) -> float:
        return self.trace.busy_s

    def breakdown(self) -> dict:
        return self.trace.breakdown()

    def idle_percent(self) -> float | None:
        if not self.trace.kernels or self.window_s <= 0:
            return None
        return 100.0 * (1.0 - self.busy_s / self.window_s)


def median(values):
    return statistics.median(values) if values else None


@contextlib.contextmanager
def wrapped(spans: Spans, targets):
    """``spans.wrap`` each (owner, attr, name) for the block."""
    try:
        for owner, attr, name in targets:
            spans.wrap(owner, attr, name)
        yield
    finally:
        spans.restore()
