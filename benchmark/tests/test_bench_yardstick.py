"""The yardstick's frozen arithmetic and the check for JAX in a process."""

from __future__ import annotations

import ast
import subprocess
import sys

import pytest

from benchmark import run as R
from benchmark import yardstick as Y

from .tiny import REPO


def test_flops_copy_counts_the_bench_step():
    assert Y.analytic_flops_per_step(8, 128, 64) == 544_890_421_248
    assert Y.analytic_flops_per_step(8, 1024, 64) == 64 * 544_890_421_248
    assert Y.forward_flops(8, 128, 64) * 3 == 544_890_421_248


def test_conv_bound_is_at_least_the_operations_bound():
    peak = Y.PEAKS["NVIDIA H100 80GB HBM3"]
    ops = Y.analytic_flops_per_step(8, 128, 64) / peak["flops"]
    assert ops <= Y.conv_bound_seconds(8, 128, 64, peak, 3) <= 1.2 * ops
    # the 1x1 output convolution at 128x128 is bound by its bytes
    assert Y.conv_layers(128, 64)[-1] == (64, 1, 128, 1, 128)


def test_k1_bytes_from_shapes():
    assert Y.k1_bytes(8, 128, 128, backward=False) == 4 * (2 * 8 * 128 * 128 + 8 + 48)
    assert Y.k1_bytes(8, 128, 128, backward=True) == 4 * (3 * 8 * 128 * 128 + 8 + 48)


@pytest.mark.parametrize("spans, busy, span, gaps", [
    ([], 0.0, 0.0, []),
    ([(0, 1)], 1, 1, []),
    ([(0, 1), (0.5, 2), (3, 4)], 3, 4, [(2, 3)]),
    ([(3, 4), (0, 10), (11, 12)], 11, 12, [(10, 11)]),  # nested and unsorted
    ([(0, 2), (2, 3)], 3, 3, []),  # touching
])
def test_busy_union_and_gaps(spans, busy, span, gaps):
    assert Y.busy_union(spans) == (busy, span)
    assert Y.idle_gaps(spans) == gaps


@pytest.mark.parametrize("modules, found", [
    (["physics_informed_image_segmentation_tpu_torch", "physics_informed_image_segmentation_tpu_torch.ops"], []),
    (["physics_informed_image_segmentation_tpu.ops.pde"], ["physics_informed_image_segmentation_tpu"]),
    (["jax", "jaxlib.xla_client", "flax.linen"], ["flax", "jax", "jaxlib"]),
    (["jaxtyping", "flaxen", "jax_foo"], []),
])
def test_forbidden_modules_by_whole_top_level_name(modules, found):
    assert R.forbidden_modules(modules) == found


def test_a_run_loads_no_jax():
    code = ("import json, benchmark.run as R, benchmark.calibrate, benchmark.trace\n"
            "import physics_informed_image_segmentation_tpu_torch\n"
            "for w in json.load(open('BENCHMARK.json'))['workloads']:\n"
            "    s = R.load_cell(w['name']); R.driver_of(s)\n"
            "    [R.reader_of(s, m['name']) for m in s.per_layer]\n"
            "print(R.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300, check=True)
    assert out.stdout.strip() == "[]"


def test_reference_imports_nothing_of_the_programs():
    for path in (REPO / "benchmark/reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for name in names:
                assert name.split(".")[0] in {"torch", "typing", "__future__", "math"}, (path, name)


@pytest.mark.parametrize("name, kind", [
    ("(anonymous namespace)::physics_fwd(float const*, float const*, (anonymous namespace)::Grid)",
     "physics_fwd"),
    ("(anonymous namespace)::physics_bwd(float const*)", "physics_bwd"),
    ("physics_fwd", "physics_fwd"),
    ("(anonymous namespace)::padded_fwd(float const*)", None),
    ("physics_fwd_other(int)", None),
])
def test_k1_reader_finds_its_kernels_by_name(name, kind):
    spec = R.load_cell("train-1024-b8")
    assert R.reader_of(spec, "k1_roofline.train")._kind(name) == kind
