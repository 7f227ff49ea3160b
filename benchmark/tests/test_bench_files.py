"""The benchmark is driven by files found by name: every cell's
configuration, mix, limits, driver and metric readers load, the file
obeys the contract's shapes, and a new cell, mix and metric are found
without editing any file that exists."""

from __future__ import annotations

import hashlib
import json
import re
import shutil

import pytest

from benchmark import run as R

from .tiny import REPO

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"] and 1 <= BENCH["run_seconds"] <= 51
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert {"setup_s"} <= {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
    lines = [c["source"] for c in BENCH["configs"]] + [m["layer"] for m in BENCH["per_layer"]]
    lines += [e["why"] for e in BENCH["configs"] + BENCH["workloads"]] + BENCH["command"]
    assert all(1 <= len(t) <= 200 and "\n" not in t and "\t" not in t for t in lines)


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_loads_by_name(cell):
    spec = R.load_cell(cell)
    driver = R.driver_of(spec)
    assert hasattr(driver, "setup")
    assert spec.limits and all(v > 0 for v in spec.limits.values())
    e2e = {m["name"] for m in spec.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert spec.per_layer
    for m in spec.per_layer:
        reader = R.reader_of(spec, m["name"])
        assert reader.UNIT == m["unit"] and reader.SOURCE == m["source"]
        assert reader.MOVES in R.quantities(m["moves"]) and m["moves"] in e2e


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in root.rglob("*") if p.is_file() and "__pycache__" not in p.parts}


def test_new_cell_mix_and_metric_are_new_files_only(tmp_path):
    shutil.copytree(REPO / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(tmp_path / "benchmark")
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    here = tmp_path / "benchmark"
    mix = json.loads((here / "traffic/dir670-b128.json").read_text())
    mix["request_images"] = 64
    (here / "traffic/dir64-b128.json").write_text(json.dumps(mix))
    shutil.copy(here / "limits/predict-128-b128.json", here / "limits/predict-128-small.json")
    (here / "metrics/requests.predict.py").write_text(
        'UNIT = "requests"\nSOURCE = "program_counter"\nMOVES = "predict_img_per_s"\n\n'
        'def read(ctx):\n    return ctx.work.get("requests")\n')
    bench["workloads"].append({"name": "predict-128-small", "config": "unet64-128",
                               "traffic": "dir64-b128", "chips": 1, "why": "new"})
    for m in bench["end_to_end"]:
        if "predict-128-b128" in m.get("workloads", []):
            m["workloads"].append("predict-128-small")
    bench["per_layer"].append({"name": "requests.predict", "unit": "requests", "better": "higher",
                               "source": "program_counter", "layer": "serve.py",
                               "moves": "predict_img_per_s", "workloads": ["predict-128-small"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    spec = R.load_cell("predict-128-small", tmp_path)
    assert spec.traffic["request_images"] == 64
    assert [m["name"] for m in spec.per_layer] == ["requests.predict"]
    reader = R.reader_of(spec, "requests.predict")
    assert reader.read(type("Ctx", (), {"work": {"requests": 7}})) == 7
    after = _digests(here)
    assert all(after[p] == d for p, d in before.items())  # nothing that existed was edited


def test_a_split_metric_reads_its_quantity():
    """``<quantity>.<tag>`` takes the value and the reader of ``<quantity>``
    where it has none of its own; a name with a reader of its own keeps it."""
    assert R.quantities("predict_img_per_s.b8") == ["predict_img_per_s.b8", "predict_img_per_s"]
    spec = R.load_cell("predict-128-b128")
    assert R.reader_of(spec, "mfu.predict.b8").__name__ == "benchmark_metric_mfu.predict"
    assert R.reader_of(spec, "mfu.train").__name__ == "benchmark_metric_mfu.train"
    with pytest.raises(FileNotFoundError):
        R.reader_of(spec, "no_such_metric.b8")
