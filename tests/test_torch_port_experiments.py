"""PyTorch port: the ablation engine, the model comparison and their CLIs,
held against the JAX package from the same weights and data.

Both sides train at base 4, 32x32, float32 and dropout 0 from the JAX
init (transplanted through ``utils/weights.py::state_dict_from_jax`` by a
monkeypatched ``UNet``), with ``batch_size`` above the number of training
images, so that each epoch is one batch and the shuffle order cannot
matter.  The JAX side runs the Pallas physics backend (interpreted on the
CPU): its plain backend runs the stencils over (W, C).

Tolerances: stage rows and parameters rtol 2e-4 (atol 1e-7), those of
test_torch_port_train.py.  Per-image test metrics are compared on the
same weights (the JAX variant's saved parameters evaluated by the port),
so that no threshold flip after training decides a test: Dice, IoU and
Hausdorff bit for bit, as in test_torch_port_metrics_data.py; boundary F1
within one float32 rounding (rtol 2**-23), because the JAX evaluation
compiles the metric and XLA rounds its ratio once differently from the
same ops run one by one.  The statistics over those arrays: rtol 1e-6.
"""

import ast
import csv
import dataclasses
import json
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from physics_informed_image_segmentation_tpu.data import DeviceDataset as JaxDataset
from physics_informed_image_segmentation_tpu.experiments import ablation as jax_ablation
from physics_informed_image_segmentation_tpu.experiments import compare as jax_compare
from physics_informed_image_segmentation_tpu.models import UNet as JaxUNet
from physics_informed_image_segmentation_tpu.train.checkpoint import load_params as jax_load_params
from physics_informed_image_segmentation_tpu_torch import evaluate as evaluate_cli
from physics_informed_image_segmentation_tpu_torch import run_ablation as ablation_cli
from physics_informed_image_segmentation_tpu_torch.data import (
    DeviceDataset,
    make_blobs,
    write_synthetic_coco,
)
from physics_informed_image_segmentation_tpu_torch.experiments import ablation, compare, studies
from physics_informed_image_segmentation_tpu_torch.models import UNet
from physics_informed_image_segmentation_tpu_torch.train.evaluation import evaluate_model
from physics_informed_image_segmentation_tpu_torch.utils.weights import state_dict_from_jax

REPO = Path(__file__).resolve().parent.parent
C, HW, SEED = 4, 32, 42
SPLITS = {"train": (0, 8), "val": (8, 10), "in_dist": (10, 14), "out_dist": (14, 18)}
FAST = dict(batch_size=10, learning_rate=1e-3, stage1_epochs=3, stage2_epochs=2,
            early_stopping_patience=1, precision="f32", base_channels=C)
ROW_RTOL, ROW_ATOL = 2e-4, 1e-7
METRIC_RTOL = {"dice_scores": 0.0, "iou_scores": 0.0, "boundary_f1_scores": 2.0 ** -23,
               "hausdorff_distances": 0.0}
STAT_RTOL = 1e-6

# the three shapes of a variant: R1.0 (one stage), S1.1 (two stages with
# PDE, on half the training set) and R1.3 with the Stage III control
SINGLE = studies.define_ablation_r1()[0]
TWO = dataclasses.replace(studies.define_ablation_s1()[1], train_fraction=0.5)
THREE = dataclasses.replace(studies.define_ablation_r1()[3], use_three_stage=True,
                            stage1_epochs=3)
SHAPES = {"single": SINGLE, "two": TWO, "three": THREE}
# result key of a saved model -> the prefix of its test metrics' keys
MODEL_METRICS = {"model_path": "", "baseline_model_path": "baseline_",
                 "pde_model_path": "pde_"}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module's tests, the previous count after
    it: the suite runs several test processes side by side on one host."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _jax_init_weights():
    """The parameters the JAX variant draws for ``SEED``, as a state dict."""
    init_key, _ = jax.random.split(jax.random.key(SEED))
    params_key, _ = jax.random.split(init_key)
    params = JaxUNet(base_channels=C, dropout=0.0, dtype=jnp.float32).init(
        params_key, jnp.zeros((1, HW, HW, 1), jnp.float32))
    return state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params), dropout=0.0)


def _patch_unets(mp):
    weights = _jax_init_weights()

    def port_unet(generator=None, **kw):
        model = UNet(dropout=0.0, **kw)
        model.load_state_dict(weights)
        return model

    mp.setattr(jax_ablation, "UNet", lambda **kw: JaxUNet(**{**kw, "dropout": 0.0}))
    mp.setattr(ablation, "UNet", port_unet)


def _data():
    images, masks = make_blobs(18, HW, HW, seed=1)
    jax_data = {k: JaxDataset.from_numpy(images[a:b], masks[a:b]) for k, (a, b) in SPLITS.items()}
    data = {k: DeviceDataset.from_numpy(images[a:b], masks[a:b], "cpu")
            for k, (a, b) in SPLITS.items()}
    return jax_data, data


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """A two-variant study (one stage, two stages) and a three-stage variant,
    run by both packages from the same weights."""
    root = tmp_path_factory.mktemp("experiments")
    jax_data, data = _data()
    with pytest.MonkeyPatch.context() as mp:
        _patch_unets(mp)
        jax_study = jax_ablation.run_ablation_study(
            "MINI", [SINGLE, TWO], datasets=jax_data, output_dir=root / "jax",
            physics_backend="pallas", **FAST)
        study = ablation.run_ablation_study(
            "MINI", [SINGLE, TWO], datasets=data, output_dir=root / "port", device="cpu", **FAST)
        jax_three = jax_ablation.run_ablation_variant(
            THREE, datasets=jax_data, ablation_folder=root / "jax3", physics_backend="pallas",
            **FAST)
        three = ablation.run_ablation_variant(
            THREE, datasets=data, ablation_folder=root / "port3", device="cpu", **FAST)
    results = {}
    for shape, cfg in (("single", SINGLE), ("two", TWO)):
        results[shape] = tuple(
            (json.loads((Path(s["ablation_folder"]) / f"{ablation._snake(cfg.name)}_results.json")
                        .read_text()), Path(s["ablation_folder"]))
            for s in (jax_study, study))
    results["three"] = ((jax_three, root / "jax3"), (three, root / "port3"))
    return {"results": results, "jax_study": jax_study, "study": study, "data": data,
            "jax_data": jax_data, "root": root}


def _read_rows(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def _stem(shape):
    return ablation._snake(SHAPES[shape].name)


@pytest.mark.parametrize("shape", list(SHAPES))
def test_variant_stage_rows_match_jax(runs, shape):
    (_, jax_dir), (_, port_dir) = runs["results"][shape]
    stem = _stem(shape)
    names = sorted(p.name for p in port_dir.glob(f"{stem}_stage?_metrics.csv"))
    assert names == sorted(p.name for p in jax_dir.glob(f"{stem}_stage?_metrics.csv"))
    assert len(names) == {"single": 1, "two": 2, "three": 3}[shape]
    for name in names:
        rows, jrows = _read_rows(port_dir / name), _read_rows(jax_dir / name)
        assert len(rows) == len(jrows), name  # the same stop epochs
        for row, jrow in zip(rows, jrows):
            assert list(row) == list(jrow)
            for k in row:
                np.testing.assert_allclose(float(row[k]), float(jrow[k]), rtol=ROW_RTOL,
                                           atol=ROW_ATOL, err_msg=f"{name} epoch {row['epoch']} {k}")
    if shape != "single":
        stage2 = _read_rows(port_dir / f"{stem}_stage2_metrics.csv")
        assert all(float(r["train_pde_loss"]) > 0 for r in stage2)
    if shape == "three":  # Stage III trains exactly as many epochs as Stage II ran
        assert len(_read_rows(port_dir / f"{stem}_stage3_metrics.csv")) == len(stage2)


@pytest.mark.parametrize("shape", list(SHAPES))
def test_variant_saved_parameters_match_jax(runs, shape):
    (jax_res, _), (res, _) = runs["results"][shape]
    keys = [k for k in MODEL_METRICS if res.get(k)]
    assert keys == [k for k in MODEL_METRICS if jax_res.get(k)]
    for key in keys:
        ref = state_dict_from_jax(jax_load_params(jax_res[key]), dropout=0.0)
        ours = torch.load(res[key], weights_only=True)
        assert sorted(ours) == sorted(ref)
        for name in ref:
            np.testing.assert_allclose(ours[name].numpy(), ref[name].numpy(), rtol=ROW_RTOL,
                                       atol=ROW_ATOL, err_msg=f"{key} {name}")


def _keys(tree):
    if isinstance(tree, dict):
        return {k: _keys(v) for k, v in tree.items()}
    return None


@pytest.mark.parametrize("shape", list(SHAPES))
def test_variant_artifacts_and_result_keys_match_jax(runs, shape):
    (jax_res, jax_dir), (res, port_dir) = runs["results"][shape]
    stem = _stem(shape)
    ours = sorted(p.name for p in port_dir.glob(f"{stem}_*"))
    ref = sorted(p.name.replace(".msgpack", ".pth") for p in jax_dir.glob(f"{stem}_*"))
    assert ours == ref
    assert _keys(res) == _keys(jax_res)
    assert res["config"] == jax_res["config"]
    for key in MODEL_METRICS:
        if res.get(key):
            assert Path(res[key]).name == Path(jax_res[key]).name.replace(".msgpack", ".pth")


def _assert_metrics_equal(ours, ref, where=""):
    assert list(ours) == list(ref)
    for metric, values in ref.items():
        np.testing.assert_allclose(ours[metric], np.asarray(values, np.float64),
                                   rtol=METRIC_RTOL[metric], atol=0, err_msg=f"{where} {metric}")


@pytest.mark.parametrize("shape", list(SHAPES))
def test_variant_test_metrics_on_the_same_weights(runs, shape):
    """Each model the JAX variant saved, evaluated by the port on both test
    sets, gives the JAX variant's per-image metrics bit for bit."""
    (jax_res, _), _ = runs["results"][shape]
    data = runs["data"]
    for key, prefix in MODEL_METRICS.items():
        if not jax_res.get(key):
            continue
        model = UNet(base_channels=C, dropout=0.0)
        model.load_state_dict(state_dict_from_jax(jax_load_params(jax_res[key]), dropout=0.0))
        for dist in ("in_dist", "out_dist"):
            ours = evaluate_model(model, data[dist], FAST["batch_size"], precision="f32")
            ref = jax_res[f"{prefix}{dist}_metrics"]
            assert list(ours) == list(ref)
            _assert_metrics_equal(ours, ref, f"{key} {dist}")


def _untimed(study, key):
    """A study file's name with the study's timestamp taken out."""
    stamp = Path(study["ablation_folder"]).name[len("MINI_"):]
    return Path(study[key]).name.replace(stamp, "{timestamp}")


def test_study_summaries_match_jax(runs):
    jax_study, study = runs["jax_study"], runs["study"]
    for key in ("summary_csv", "summary_csv_in_dist", "summary_csv_out_dist"):
        assert _untimed(study, key) == _untimed(jax_study, key)
        rows, jrows = _read_rows(study[key]), _read_rows(jax_study[key])
        assert [(r["variant"], r["metric"], r["count"], r["std"]) for r in rows] == \
            [(r["variant"], r["metric"], r["count"], r["std"]) for r in jrows]
        for r, jr in zip(rows, jrows):
            np.testing.assert_allclose(float(r["mean"]), float(jr["mean"]), rtol=STAT_RTOL)
    data = json.loads(Path(study["results_json"]).read_text())
    jdata = json.loads(Path(jax_study["results_json"]).read_text())
    assert _keys({k: v for k, v in data.items() if k != "results"}) == \
        _keys({k: v for k, v in jdata.items() if k != "results"})
    assert data["variants"] == jdata["variants"]
    assert data["aggregated_results"] == data["aggregated_results_in_dist"]
    assert set(study) == set(jax_study)
    assert _untimed(study, "results_json") == _untimed(jax_study, "results_json")


@pytest.fixture(scope="module")
def crashed_study(runs, tmp_path_factory):
    """The port's study of ``runs`` crashed after Stage II epoch 1 of its
    second variant."""
    out = tmp_path_factory.mktemp("crashed")
    with pytest.MonkeyPatch.context() as mp:
        _patch_unets(mp)
        mp.setenv("PIIS_FAULT_AFTER", "Stage II (PDE):1")
        with pytest.raises(RuntimeError, match="injected crash after Stage II"):
            ablation.run_ablation_study("MINI", [SINGLE, TWO], datasets=runs["data"],
                                        output_dir=out, device="cpu", **FAST)
    (folder,) = out.glob("MINI_*")
    assert (folder / f"{ablation._snake(SINGLE.name)}_results.json").exists()
    assert not (folder / f"{ablation._snake(TWO.name)}_results.json").exists()
    return folder


@pytest.mark.parametrize("first_json", ["intact", "corrupt"])
def test_study_resumed_after_a_crash_gives_the_uninterrupted_aggregate(
        runs, crashed_study, tmp_path, monkeypatch, first_json):
    folder = tmp_path / crashed_study.name
    shutil.copytree(crashed_study, folder)
    if first_json == "corrupt":  # a truncated write: that variant retrains
        path = folder / f"{ablation._snake(SINGLE.name)}_results.json"
        path.write_text(path.read_text()[:100])
    _patch_unets(monkeypatch)
    retrained = []
    real = ablation.run_ablation_variant
    monkeypatch.setattr(ablation, "run_ablation_variant",
                        lambda cfg, **kw: retrained.append(cfg.name) or real(cfg, **kw))
    res = ablation.run_ablation_study("MINI", [SINGLE, TWO], datasets=runs["data"],
                                      output_dir=tmp_path, resume_from=folder, device="cpu",
                                      **FAST)
    assert retrained == ([TWO.name] if first_json == "intact" else [SINGLE.name, TWO.name])
    assert res["ablation_folder"] == str(folder)
    assert Path(res["results_json"]).name == f"ablation_{folder.name}.json"  # its timestamp
    data = json.loads(Path(res["results_json"]).read_text())
    ref = json.loads(Path(runs["study"]["results_json"]).read_text())
    for key in ("aggregated_results", "aggregated_results_out_dist"):
        # as JSON text: a Hausdorff distance of an empty prediction is NaN
        assert json.dumps(data[key], sort_keys=True) == json.dumps(ref[key], sort_keys=True)
    assert [r["config"]["name"] for r in data["results"]] == [SINGLE.name, TWO.name]


def _pth_pair(runs, tmp_path):
    """The three-stage JAX variant's Stage I and Stage II parameters as .pth
    files for the port's default U-Net; returns the .msgpack and .pth pairs."""
    (jax_res, _), _ = runs["results"]["three"]
    msgpacks = [Path(jax_res["baseline_model_path"]), Path(jax_res["pde_model_path"])]
    pths = []
    for path in msgpacks:
        pths.append(tmp_path / path.with_suffix(".pth").name)
        torch.save(state_dict_from_jax(jax_load_params(path)), pths[-1])
    return msgpacks, pths


def _assert_comparisons_equal(ours, ref):
    assert list(ours) == list(ref)
    for metric in ref:
        for k, v in ref[metric].items():
            if isinstance(v, bool):
                assert ours[metric][k] is v
            else:
                np.testing.assert_allclose(ours[metric][k], v, rtol=STAT_RTOL, err_msg=k)


def _parsed_floats(path):
    out = []
    for row in _read_rows(path):
        out.append({k: (v if k in ("", "metric", "model") or v in ("True", "False", "")
                        else float(v)) for k, v in row.items()})
    return out


def test_evaluate_and_compare_matches_jax(runs, tmp_path):
    (jb, jp), (pb, pp) = _pth_pair(runs, tmp_path)
    common = dict(batch_size=4, test_data=runs["data"]["in_dist"], base_channels=C)
    res = compare.evaluate_and_compare(pb, pp, None, None, output_dir=tmp_path / "ours",
                                       precision="f32", device="cpu", **common)
    ref = jax_compare.evaluate_and_compare(jb, jp, None, None, output_dir=tmp_path / "ref",
                                           dtype="f32",
                                           **{**common, "test_data": runs["jax_data"]["in_dist"]})
    for which in ("baseline_metrics", "pde_metrics"):
        _assert_metrics_equal(res[which], ref[which], which)
    _assert_comparisons_equal(res["comparison_results"], ref["comparison_results"])
    for key in ("results_csv", "summary_csv"):
        assert Path(res[key]).name.split("_20")[0] == Path(ref[key]).name.split("_20")[0]
        ours, theirs = _parsed_floats(res[key]), _parsed_floats(ref[key])
        assert [list(r) for r in ours] == [list(r) for r in theirs]
        for a, b in zip(ours, theirs):
            for k in b:
                if isinstance(b[k], float):
                    np.testing.assert_allclose(a[k], b[k], rtol=STAT_RTOL, err_msg=f"{key} {k}")
                else:
                    assert a[k] == b[k], (key, k)
    ours = json.loads(Path(res["comparison_json"]).read_text())
    _assert_comparisons_equal(ours, json.loads(Path(ref["comparison_json"]).read_text()))


def test_run_repeated_evaluations_matches_jax(runs, tmp_path):
    (jb, jp), (pb, pp) = _pth_pair(runs, tmp_path)
    common = dict(batch_size=4, test_data=runs["data"]["out_dist"], base_channels=C)
    res = compare.run_repeated_evaluations([pb, pp], [pp, pb], None, None,
                                           output_dir=tmp_path / "ours", precision="f32",
                                           device="cpu", **common)
    ref = jax_compare.run_repeated_evaluations(
        [jb, jp], [jp, jb], None, None, output_dir=tmp_path / "ref", dtype="f32",
        **{**common, "test_data": runs["jax_data"]["out_dist"]})
    assert len(res["baseline_metrics"]["dice_scores"]) == 8
    for which in ("baseline_metrics", "pde_metrics"):
        _assert_metrics_equal(res[which], ref[which], which)
    _assert_comparisons_equal(res["comparison_results"], ref["comparison_results"])
    ours, theirs = _parsed_floats(res["aggregated_csv"]), _parsed_floats(ref["aggregated_csv"])
    assert [(r["metric"], r["model"], r["count"]) for r in ours] == \
        [(r["metric"], r["model"], r["count"]) for r in theirs]
    for a, b in zip(ours, theirs):
        np.testing.assert_allclose([a["mean"], a["std"]], [b["mean"], b["std"]], rtol=STAT_RTOL)


def test_load_unet_params_refuses_msgpack(runs):
    """(Named when a ``.msgpack`` was refused.)  The ``.msgpack`` that the
    JAX study wrote loads: the model holds its parameters exactly as
    ``state_dict_from_jax`` maps them."""
    (jax_res, _), _ = runs["results"]["three"]
    model, _ = compare.load_unet_params(jax_res["model_path"], base_channels=C, device="cpu")
    ref = state_dict_from_jax(jax_load_params(jax_res["model_path"]))
    sd = model.state_dict()
    assert set(sd) == set(ref)
    for k, v in sd.items():
        torch.testing.assert_close(v, ref[k], rtol=0, atol=0, msg=k)


# ---------------------------------------------------------------- the CLIs


def _root_arguments(name):
    """``{flag: kwargs}`` of every ``add_argument`` call of a root CLI."""
    out = {}
    for node in ast.walk(ast.parse((REPO / name).read_text())):
        if isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "add_argument":
            flags = [ast.literal_eval(a) for a in node.args]
            out[flags[0]] = {k.arg: (ast.literal_eval(k.value)
                                     if not isinstance(k.value, ast.Name) else k.value.id)
                             for k in node.keywords}
    return out


@pytest.mark.parametrize("root,port", [("evaluate.py", evaluate_cli),
                                       ("run_ablation.py", ablation_cli)])
def test_cli_takes_every_flag_of_the_root_cli(root, port):
    ref = _root_arguments(root)
    actions = {a.option_strings[0]: a for a in port.build_parser()._actions if a.option_strings}
    assert len(ref) >= 10 and set(ref) <= set(actions), set(ref) - set(actions)
    assert set(actions) - set(ref) == {"-h", "--device"}
    assert actions["--device"].default == "cuda"
    for flag, kw in ref.items():
        action = actions[flag]
        assert action.default == kw.get("default", False if kw.get("action") else None), flag
        assert (action.type.__name__ if action.type else None) == kw.get("type"), flag
        assert action.required == kw.get("required", False), flag
        assert action.nargs == kw.get("nargs", 0 if kw.get("action") else None), flag
        assert action.const == kw.get("const", True if kw.get("action") else None), flag
        if flag == "--physics-backend":
            assert action.choices == ["auto", "cuda", "torch"]
        else:
            assert action.choices == kw.get("choices"), flag


def _write_study_layout(root: Path, n=4, hw=32):
    """images/{training,validation,in_dist_testing,out_dist_testing}/ and
    images/annotation/{split}_annotation.json (the root CLIs' defaults)."""
    ann_dir = root / "images" / "annotation"
    ann_dir.mkdir(parents=True)
    for i, split in enumerate(("training", "validation", "in_dist_testing",
                               "out_dist_testing")):
        img_dir, ann = write_synthetic_coco(root / "tmp" / split, n=n, height=hw, width=hw,
                                            seed=i)
        shutil.move(str(img_dir), root / "images" / split)
        shutil.move(str(ann), ann_dir / f"{split}_annotation.json")
    shutil.rmtree(root / "tmp")


def test_clis_end_to_end_on_cpu(tmp_path, monkeypatch, capsys):
    """run_ablation R1 (the deprecated --test-dir naming the in-distribution
    set), its --resume, then evaluate's three modes on what it wrote."""
    _write_study_layout(tmp_path)
    monkeypatch.chdir(tmp_path)
    common = ["--device", "cpu", "--base-channels", "4", "--batch-size", "4",
              "--precision", "f32"]
    ablation_cli.main(["--ablation", "R1", "--stage1-epochs", "1", "--stage2-epochs", "1",
                       "--test-dir", "images/in_dist_testing",
                       "--test-json", "images/annotation/in_dist_testing_annotation.json",
                       *common])
    text = capsys.readouterr().out
    assert "--test-dir and --test-json are deprecated" in text
    assert "ALL ABLATION STUDIES COMPLETE" in text
    (folder,) = (tmp_path / "output" / "ablation").glob("R1_*")
    assert len(list(folder.glob("*_results.json"))) == 4
    assert len(list(folder.glob(f"ablation_R1_{folder.name[3:]}_summary*.csv"))) == 3

    ablation_cli.main(["--ablation", "R1", "--resume", *common])
    text = capsys.readouterr().out
    assert f"Resuming study from: {folder}" in text
    assert text.count("loaded completed results") == 4

    stem = "r1.3_rd_+_phase-field"
    common = ["--device", "cpu", "--base-channels", "4", "--batch-size", "4",
              "--test-dir", "images/in_dist_testing",
              "--test-json", "images/annotation/in_dist_testing_annotation.json"]
    baseline, pde = (folder / f"{stem}_baseline_after_stage1.pth",
                     folder / f"{stem}_after_pde_stage2.pth")
    evaluate_cli.main(["--baseline", str(baseline), "--pde", str(pde), "--output-dir", "pair",
                       *common])
    names = sorted(p.name.split("_20")[0] for p in (tmp_path / "pair").iterdir())
    assert names == ["evaluation_results", "evaluation_summary", "statistical_comparison"]
    evaluate_cli.main(["--baseline", str(folder / "*_baseline_after_stage1.pth"),
                       "--pde", str(folder / "*_after_pde_stage2.pth"), "--repeated",
                       "--output-dir", "repeated", *common])
    assert "Found 3 baseline models" in capsys.readouterr().out
    (agg,) = (tmp_path / "repeated").glob("aggregated_results_*.csv")
    assert [r["count"] for r in _read_rows(agg)][:2] == ["12", "12"]
    evaluate_cli.main(["--model-path", str(pde), "--output-dir", "single", *common])
    payload = json.loads((tmp_path / "single" / f"single_model_metrics_{pde.stem}.json")
                         .read_text())
    assert set(payload) == {"dice_scores", "iou_scores", "boundary_f1_scores",
                            "hausdorff_distances"}
    assert payload["dice_scores"]["statistics"]["count"] == 4
    assert "EVALUATION COMPLETE" in capsys.readouterr().out


def test_clis_raise_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ablation_cli.main(["--ablation", "R1", "--output-dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        evaluate_cli.main(["--model-path", str(tmp_path / "none.pth")])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        compare.load_unet_params(tmp_path / "none.pth", base_channels=C)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ablation.run_ablation_variant(SINGLE, datasets=_data()[1], ablation_folder=tmp_path)
    assert list(tmp_path.iterdir()) == []
