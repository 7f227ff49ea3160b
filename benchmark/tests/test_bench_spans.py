"""``benchmark/spans.py`` on made-up traces: the clock offset, the idle
split among the spans open on the host, the charge of backward operations
through ``sequence_nr``, and no reading where the program opened no span."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from benchmark import run as R
from benchmark.spans import OUTSIDE, spans_of
from benchmark.trace import Trace

T0 = 5000.0  # the profiler's start on the device operations' clock, s
US = 1e-6


class Ev:
    """A host event as ``FunctionEvent`` gives it: µs from the profiler's
    start, its parent and children."""

    def __init__(self, name, start, end, parent=None, seq=-1):
        self.name, self.sequence_nr = name, seq
        self.time_range = SimpleNamespace(start=start, end=end)
        self.cpu_parent, self.cpu_children = parent, []
        if parent is not None:
            parent.cpu_children.append(self)


def _launcher(name, start, end, parent, call, at):
    """An operation that launched one device operation through runtime
    call ``call`` at ``at`` µs."""
    op = Ev(name, start, end, parent)
    Ev(call, at, at + 1, op)
    return op


def _trace(ops, window_s):
    """A :class:`Trace` of ``(start_us, end_us, name, launcher)`` device
    operations, ``start_us`` and ``end_us`` counted from ``T0``."""
    tr = object.__new__(Trace)
    tr.ops = [(T0 + s * US, T0 + e * US, n, launcher) for s, e, n, launcher in ops]
    tr.window_s = window_s
    return tr


def _read(cell, metric, trace):
    ctx = SimpleNamespace(trace=trace, work={}, peak=None)
    return R.reader_of(R.load_cell(cell), metric).read(ctx)


def _serving():
    """Two requests; the kernel starts 2 µs after the runtime call that
    launched it, so the spans sit 2 µs later on the device's clock (a copy,
    1 µs after its call, does not count).  The last operation is linked to
    a profiler event of its own that starts after it and launched nothing."""
    p1 = Ev("piis.predict", 0, 1000)
    up1, fw1 = Ev("piis.upload", 0, 100, p1), Ev("piis.forward", 100, 400, p1)
    fe1 = Ev("piis.fetch", 600, 800, p1)
    Ev("piis.threshold", 850, 950, p1)
    p2 = Ev("piis.predict", 1100, 1200)
    up2 = Ev("piis.upload", 1100, 1150, p2)
    ops = [(53, 83, "Memcpy HtoD (Pageable -> Device)",
            _launcher("aten::copy_", 50, 90, up1, "cudaMemcpyAsync", 52)),
           (123, 600, "sm90_xmma_fprop",
            _launcher("aten::conv2d", 110, 130, fw1, "cudaLaunchKernel", 121)),
           (620, 780, "Memcpy DtoH (Device -> Pageable)",
            _launcher("aten::copy_", 610, 790, fe1, "cudaMemcpyAsync", 612)),
           (1125, 1135, "Memcpy HtoD (Pageable -> Device)",
            _launcher("aten::copy_", 1120, 1125, up2, "cudaMemcpyAsync", 1122)),
           (1130, 1131, "kernel", Ev("Buffer Flush", 1180, 1181, p2))]
    return _trace(ops, 1250 * US)


def test_clock_offset_is_a_kernels_launch_delay():
    sp = spans_of(_serving())
    assert sp.offset_s == pytest.approx(T0 + 2 * US, abs=1e-9)


def test_clock_offset_is_the_fifth_smallest_kernel_delay():
    """Seven kernels, one of them paired with a call made after it starts;
    a launcher with two launch calls and one kernel is left out."""
    step = Ev("piis.step", 0, 1000)
    ops = []
    for k, delay in enumerate([-700, 4, 5, 5, 6, 6, 9]):
        call = 100 * k + 10
        ops.append((call + delay, call + delay + 1, "kernel",
                    _launcher("aten::add", call - 5, call + 5, step, "cudaLaunchKernel", call)))
    odd = _launcher("aten::mul", 800, 900, step, "cudaLaunchKernel", 890)
    Ev("cuLaunchKernel", 895, 896, odd)
    ops.append((850, 851, "kernel", odd))
    sp = spans_of(_trace(ops, 1000 * US))
    assert sp.offset_pairs == 7
    assert sp.offset_s == pytest.approx(T0 + 6 * US, abs=1e-9)


def test_idle_is_split_by_the_innermost_open_span():
    tr = _serving()
    sp = spans_of(tr)
    # the window is 50 µs longer than the first span's start to the last one's end
    expect = {"piis.upload": 110, "piis.forward": 21, "piis.predict": 152, "piis.fetch": 40,
              "piis.threshold": 100, OUTSIDE: 150}
    assert sp.idle_s.keys() == expect.keys()
    for name, us in expect.items():
        assert sp.idle_s[name] == pytest.approx(us * US, abs=1e-9), name
    # idle and busy add up to the window
    assert sum(sp.idle_s.values()) + tr.busy_s == pytest.approx(tr.window_s, abs=1e-9)
    assert sp.device_s == pytest.approx({"piis.upload": 40 * US, "piis.forward": 477 * US,
                                         "piis.fetch": 160 * US, "piis.predict": 1 * US},
                                        abs=1e-9)
    assert _read("predict-128-b128", "idle_upload.predict", tr) == pytest.approx(8.8)
    assert _read("predict-128-b128", "idle_fetch.predict", tr) == pytest.approx(11.2)
    assert _read("predict-128-b128", "copy_share.predict", tr) == pytest.approx(16.0)


def _training():
    """One step.  The forward's conv makes autograd node 10; an operation
    there that makes no node records the next number, 11, which the
    objective's node takes.  Backward nodes on autograd's thread (roots of
    their own), and one on the main thread inside ``piis.backward``."""
    step = Ev("piis.step", 0, 1000)
    fw, ob = Ev("piis.forward", 0, 200, step), Ev("piis.objective", 200, 300, step)
    bw, opt = Ev("piis.backward", 300, 900, step), Ev("piis.optimizer", 900, 1000, step)
    conv = Ev("aten::conv2d", 10, 50, fw, seq=10)
    Ev("aten::view", 150, 160, fw, seq=11)
    loss = Ev("aten::mul", 210, 250, ob, seq=11)

    def node(seq, start, parent=None):
        n = Ev("autograd::engine::evaluate_function: XBackward0", start, start + 40, parent, seq)
        return Ev("aten::mul", start + 5, start + 30, n)

    ops = [(60, 160, "fprop", conv), (260, 264, "loss", loss),
           (320, 322, "loss_bwd", node(11, 310)), (410, 510, "dgrad", node(10, 400)),
           (620, 621, "unknown_bwd", node(99, 600)), (720, 750, "dgrad_here", node(10, 700, bw)),
           (915, 935, "adamw", Ev("aten::_foreach_add_", 910, 990, opt)),
           (965, 966, "stray", node(98, 950))]
    return _trace(ops, 1000 * US)


def test_backward_is_charged_to_its_forward_by_sequence_nr():
    tr = _training()
    sp = spans_of(tr)
    by_op = {name: span for _, name, span in sp.ops}
    assert by_op == {"fprop": "piis.forward", "loss": "piis.objective",
                     "loss_bwd": "piis.objective", "dgrad": "piis.forward",
                     "unknown_bwd": "piis.backward", "dgrad_here": "piis.forward",
                     "adamw": "piis.optimizer", "stray": None}
    busy = tr.busy_s
    assert busy == pytest.approx(258 * US, abs=1e-12)
    assert _read("train-1024-b8", "objective_share.train", tr) == pytest.approx(100 * 6 / 258)
    assert _read("train-1024-b8", "optim_share.train", tr) == pytest.approx(100 * 20 / 258)
    assert _read("train-1024-b8", "metrics_share.train", tr) == 0.0


@pytest.mark.parametrize("metric, cell", [
    ("objective_share.train", "train-1024-b8"), ("metrics_share.train", "train-1024-b8"),
    ("optim_share.train", "train-1024-b8"), ("idle_upload.predict", "predict-128-b128"),
    ("idle_fetch.predict", "predict-128-b128"), ("copy_share.predict", "predict-128-b128"),
])
def test_no_reading_without_spans(metric, cell):
    bare = _trace([(3, 10, "kernel", Ev("aten::conv2d", 0, 5))], 20 * US)
    assert spans_of(bare) is None
    for trace in (None, bare, _trace([], 20 * US)):
        assert _read(cell, metric, trace) is None
