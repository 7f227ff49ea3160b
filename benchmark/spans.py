"""The program's own spans (``piis.*``) in a traced window, and the device's
time and idle time charged to each.

The port marks its stage, steps and requests with spans
(``utils/profiling.py::span``): host-timeline operations of the profiler
named ``piis.<part>``, nested as the code nests.  This module finds them in
a :class:`.trace.Trace` and applies three rules.

- **Finding the spans.**  Through the device operations' launchers: each
  launcher's root (its outermost host operation) and all of that root's
  descendants.
- **Device time.**  A device operation is charged to the innermost span
  around its launcher.  Autograd's backward runs on a thread of its own,
  outside every span: an operation launched under an
  ``autograd::engine::evaluate_function`` is charged to the span of the
  forward operation with the same ``sequence_nr`` (the profiler records the
  autograd node's number on both), else to the ``piis.backward`` span open
  at its launch.  So the objective's backward counts as objective and the
  U-Net's backward as forward.
- **Idle time.**  Each instant in which no device operation runs is charged
  to the innermost span open on the host at that instant, or to
  ``OUTSIDE`` (the client's or the driver's own code, between the spans
  and in the window before the first and after the last).

Spans are timed in µs from the profiler's start, device operations in
seconds of the trace's raw clock.  The offset between the two is the
delay from the runtime call that launched a kernel (a child of its
launcher, ``cudaLaunchKernel`` or ``cuLaunchKernel``, paired with the
launcher's kernels in order) to the kernel's start: the fifth smallest
over the window, so that a few pairs the profiler got wrong cannot move
it; a few µs of launch latency too large.  Copies are left out (a
pageable copy starts after its staging), and so is a launcher whose
launch calls and kernels differ in number.
"""

from __future__ import annotations

import bisect
from collections import defaultdict

__all__ = ["PREFIX", "OUTSIDE", "Spans", "spans_of"]

PREFIX = "piis."
OUTSIDE = "outside"
BACKWARD_NODE = "autograd::engine::evaluate_function"
COPIES = ("Memcpy", "Memset")


def _launch_calls(launcher) -> list:
    """Start times (µs) of the runtime calls under ``launcher`` that launch a kernel."""
    return sorted(ch.time_range.start for ch in launcher.cpu_children
                  if ch.name.startswith("cu") and "Launch" in ch.name)


def _root(ev):
    while ev.cpu_parent is not None:
        ev = ev.cpu_parent
    return ev


class Spans:
    """``device_s`` and ``idle_s``: seconds by span name (``OUTSIDE`` for
    idle outside every span, ``None`` for device time charged to none);
    ``ops``: ``(seconds, device operation name, span name or None)`` of
    every device operation; ``found``: whether any span was found;
    ``offset_s``: a span's time in seconds plus ``offset_s`` is on the
    device operations' clock, estimated from ``offset_pairs`` pairs of a
    kernel and its launch call."""

    def __init__(self, trace):
        roots = {}
        for _, _, _, launcher in trace.ops:
            if launcher is not None:
                root = _root(launcher)
                roots[id(root)] = root
        spans, forward_span = [], {}
        todo = [(root, None, False, 0) for root in roots.values()]
        while todo:  # every descendant, with its innermost span and depth
            ev, inner, backward, depth = todo.pop()
            if ev.name.startswith(PREFIX):
                inner, depth = ev, depth + 1
                spans.append((ev, depth))
            backward = backward or ev.name.startswith(BACKWARD_NODE)
            if not backward and ev.sequence_nr >= 0 and inner is not None:
                # an operation that makes no autograd node records the next
                # node's number: the node's maker is the last to start
                t = ev.time_range.start
                if forward_span.get(ev.sequence_nr, (t,))[0] <= t:
                    forward_span[ev.sequence_nr] = (t, inner)
            todo.extend((ch, inner, backward, depth) for ch in ev.cpu_children)
        self.found = bool(spans)
        backward_spans = sorted(((ev.time_range.start, ev.time_range.end, ev)
                                 for ev, _ in spans if ev.name == PREFIX + "backward"),
                                key=lambda b: b[0])
        starts = [s for s, _, _ in backward_spans]

        def charge(launcher):
            ev = launcher
            while ev is not None:
                if ev.name.startswith(PREFIX):
                    return ev.name
                if ev.name.startswith(BACKWARD_NODE) and ev.sequence_nr in forward_span:
                    return forward_span[ev.sequence_nr][1].name
                ev = ev.cpu_parent
            k = bisect.bisect_right(starts, launcher.time_range.start) - 1
            if k >= 0 and launcher.time_range.start <= backward_spans[k][1]:
                return backward_spans[k][2].name
            return None

        self.ops = [(e - s, name, charge(launcher) if launcher is not None else None)
                    for s, e, name, launcher in trace.ops]
        self.device_s = defaultdict(float)
        for dt, _, span in self.ops:
            self.device_s[span] += dt
        kernels = defaultdict(list)
        for s, _, name, launcher in trace.ops:
            if launcher is not None and not name.startswith(COPIES):
                kernels[id(launcher)].append((s, launcher))
        delays = []
        for ops in kernels.values():
            ops.sort(key=lambda o: o[0])
            calls = _launch_calls(ops[0][1])
            if len(calls) == len(ops):
                delays += [s - t * 1e-6 for (s, _), t in zip(ops, calls)]
        self.offset_pairs = len(delays)
        if not delays:  # no runtime call in the trace: the launchers' own starts
            delays = [s - launcher.time_range.start * 1e-6 for s, _, _, launcher in trace.ops
                      if launcher is not None]
        self.offset_s = sorted(delays)[min(4, len(delays) - 1)] if delays else 0.0
        self.idle_s = self._idle(trace, [(ev.time_range.start * 1e-6 + self.offset_s,
                                          ev.time_range.end * 1e-6 + self.offset_s,
                                          depth, ev.name) for ev, depth in spans])

    @staticmethod
    def _idle(trace, spans) -> dict:
        """Idle seconds by the innermost span open on the host, from the
        first operation or span to the last one's end; the window's time
        before and after those (the driver's own code) is ``OUTSIDE``."""
        busy = sorted((s, e) for s, e, _, _ in trace.ops)
        if not busy and not spans:
            return {}
        lo = min([s for s, _ in busy] + [s for s, _, _, _ in spans])
        hi = max([e for _, e in busy] + [e for _, e, _, _ in spans])
        idle, t = [], lo
        for s, e in busy:
            if s > t:
                idle.append((t, s))
            t = max(t, e)
        if hi > t:
            idle.append((t, hi))
        # the host's timeline cut where a span opens or closes, each piece
        # named by its innermost open span
        marks = sorted([(s, 1, d, name) for s, _, d, name in spans]
                       + [(e, 0, -d, name) for _, e, d, name in spans])
        pieces, open_, t = [], [], lo
        for when, opens, d, name in marks:
            if when > t:
                pieces.append((t, when, open_[-1][1] if open_ else OUTSIDE))
                t = when
            if opens:
                open_.append((d, name))
                open_.sort()
            else:
                open_.remove((-d, name))
        pieces.append((t, hi, open_[-1][1] if open_ else OUTSIDE))
        out, j = defaultdict(float), 0
        for a, b in idle:
            while j < len(pieces) and pieces[j][1] <= a:
                j += 1
            k = j
            while k < len(pieces) and pieces[k][0] < b:
                out[pieces[k][2]] += min(b, pieces[k][1]) - max(a, pieces[k][0])
                k += 1
        out[OUTSIDE] += max(0.0, trace.window_s - (hi - lo))
        return dict(out)

    def device(self, names, op=None) -> float:
        """Device seconds charged to a span in ``names`` (of the operations
        whose name ``op`` accepts)."""
        return sum(dt for dt, n, span in self.ops
                   if span in names and (op is None or op(n)))

    def idle(self, names) -> float:
        return sum(self.idle_s.get(n, 0.0) for n in names)


def spans_of(trace):
    """The :class:`Spans` of ``trace`` (computed once a trace), or None
    where there is no trace or the program opened no span."""
    if trace is None or not trace.ops:
        return None
    found = getattr(trace, "_piis_spans", None)
    if found is None:
        found = trace._piis_spans = Spans(trace)
    return found if found.found else None
