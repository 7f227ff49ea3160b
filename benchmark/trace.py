"""What a traced run reads from ``torch.profiler``'s device trace.

The device's operations (kernels, copies, fills) with their intervals,
from the profiler's raw events, and for each the host operation that
launched it (the PyTorch operation whose correlation id the device
operation links to, with its ancestors): a per-layer reader asks for
device time by kernel name or by the host operations a kernel ran under.
"""

from __future__ import annotations

from collections import defaultdict

import torch

from .yardstick import busy_union, idle_gaps

__all__ = ["Trace"]


class Trace:
    """The device operations of one traced window.

    ``ops``: ``(start_s, end_s, name, launcher)`` of every device operation,
    ``launcher`` the host operation (a ``FunctionEvent``) that launched it,
    or None."""

    def __init__(self, prof, window_s: float):
        cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
        raw = prof.profiler.kineto_results.events()
        # operations PyTorch recorded link to nothing; runtime calls and
        # device operations link to the operation that made them
        recorded = {e.correlation_id() for e in raw
                    if e.device_type() == cpu and e.linked_correlation_id() == 0}
        host = {e.id: e for e in prof.events()
                if e.device_type == cpu and e.id in recorded and e.id != 0}
        self.window_s = window_s
        self.ops = [(e.start_ns() * 1e-9, (e.start_ns() + e.duration_ns()) * 1e-9, e.name(),
                     host.get(e.linked_correlation_id()))
                    for e in raw if e.device_type() == cuda]

    @property
    def busy_s(self) -> float:
        return busy_union([(s, e) for s, e, _, _ in self.ops])[0]

    @property
    def span_s(self) -> float:
        """From the first device operation's start to the last one's end."""
        return max(e for _, e, _, _ in self.ops) - min(s for s, _, _, _ in self.ops)

    def kernels(self, match) -> list[tuple[float, float, str]]:
        """``(start, end, name)`` of the operations whose name ``match`` accepts."""
        return [(s, e, n) for s, e, n, _ in self.ops if match(n)]

    def seconds_under(self, host_names) -> float:
        """Device seconds of the operations launched under a host operation
        named in ``host_names`` (the launcher or one of its ancestors)."""
        total = 0.0
        for s, e, _, launcher in self.ops:
            ev = launcher
            while ev is not None:
                if ev.name in host_names:
                    total += e - s
                    break
                ev = ev.cpu_parent
        return total

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took the most time, and the idle gaps
        summed by the host operation that ended them (the launch that came
        after the gap, under its outermost host operation)."""
        by_name = defaultdict(float)
        for s, e, n, _ in self.ops:
            by_name[n] += e - s
        start_of = {}
        for s, e, n, launcher in self.ops:
            start_of.setdefault(s, launcher)
        gaps = defaultdict(float)
        for g0, g1 in idle_gaps([(s, e) for s, e, _, _ in self.ops]):
            launcher = start_of.get(g1)
            if launcher is None:
                gaps["(no host operation)"] += g1 - g0
                continue
            root = launcher
            while root.cpu_parent is not None:
                root = root.cpu_parent
            gaps[root.name if root is launcher else f"{root.name} > {launcher.name}"] += g1 - g0
        return {"device_ops": sorted(([k, v] for k, v in by_name.items()),
                                     key=lambda kv: -kv[1])[:top],
                "idle_gaps": sorted(([k, v] for k, v in gaps.items()),
                                    key=lambda kv: -kv[1])[:top]}
