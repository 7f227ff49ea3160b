"""PyTorch port: the paired model comparison, the study grids, the loss
dispatch of a variant and the comparison files, held against the JAX
package on the same numbers.

The statistics are float64 SciPy calls on the same arrays in both
packages: counts and flags must be equal and the statistics within rtol
1e-12.  Files are compared once parsed; the CSV writer is also held to
pandas' text.
"""

import csv
import dataclasses
import json

import numpy as np
import pandas as pd
import pytest
import torch

from physics_informed_image_segmentation_tpu.experiments import ablation as jax_ablation
from physics_informed_image_segmentation_tpu.experiments import compare as jax_compare
from physics_informed_image_segmentation_tpu.experiments import studies as jax_studies
from physics_informed_image_segmentation_tpu.ops import stats as jax_stats
from physics_informed_image_segmentation_tpu_torch.experiments import ablation, compare, studies
from physics_informed_image_segmentation_tpu_torch.ops import stats
from physics_informed_image_segmentation_tpu_torch.train.csvlog import save_rows_to_csv

KEYS = ["dice_scores", "iou_scores", "boundary_f1_scores", "hausdorff_distances"]
STAT_RTOL = 1e-12


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module's tests, the previous count after
    it: the suite runs several test processes side by side on one host."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _pair(case, n=12, seed=0):
    """(baseline, pde) metric dicts for one named case."""
    rng = np.random.default_rng(seed)
    base = {k: rng.uniform(0.2, 0.9, n) for k in KEYS}
    base["hausdorff_distances"] = rng.uniform(1.0, 9.0, n)
    pde = {k: v + rng.normal(0.02, 0.05, n) for k, v in base.items()}
    if case == "nan_pairs":
        base["dice_scores"][[1, 4]] = np.nan
        pde["dice_scores"][[4, 7]] = np.nan
        base["hausdorff_distances"][::3] = np.nan
    elif case == "fewer_than_two_valid":
        base["iou_scores"][1:] = np.nan
        pde["boundary_f1_scores"][:] = np.nan
    elif case == "all_zero_differences":
        pde["dice_scores"] = base["dice_scores"].copy()
        pde["iou_scores"] = base["iou_scores"] + 0.0
    elif case == "identical":
        pde = {k: v.copy() for k, v in base.items()}
    elif case == "float32_inputs":
        base = {k: v.astype(np.float32) for k, v in base.items()}
        pde = {k: v.astype(np.float32) for k, v in pde.items()}
    return base, pde


def _assert_rows_equal(ours, ref, rtol=STAT_RTOL):
    assert list(ours) == list(ref)
    for metric in ref:
        assert list(ours[metric]) == list(ref[metric]), metric
        for k, v in ref[metric].items():
            if isinstance(v, (bool, np.bool_)):
                assert ours[metric][k] is bool(v), (metric, k)
            else:
                np.testing.assert_allclose(ours[metric][k], v, rtol=rtol, atol=0,
                                           err_msg=f"{metric} {k}")


CASES = ["random", "nan_pairs", "fewer_than_two_valid", "all_zero_differences", "identical",
         "float32_inputs"]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("alpha", [0.05, 0.2])
def test_compare_models_statistically_matches_jax(case, alpha):
    base, pde = _pair(case)
    with np.errstate(all="ignore"):
        ours = stats.compare_models_statistically(base, pde, alpha=alpha)
        ref = jax_stats.compare_models_statistically(base, pde, alpha=alpha)
    _assert_rows_equal(ours, ref)
    counts = {k: stats.compute_statistics(v)["count"] for k, v in base.items()}
    assert counts == {k: jax_stats.compute_statistics(v)["count"] for k, v in base.items()}


def test_degenerate_rows():
    base, pde = _pair("fewer_than_two_valid")
    with np.errstate(all="ignore"):
        rows = stats.compare_models_statistically(base, pde)
    for metric in ("iou_scores", "boundary_f1_scores"):
        row = rows[metric]
        assert row["significant"] is False
        assert all(np.isnan(v) for k, v in row.items() if k != "significant")
    base, pde = _pair("all_zero_differences")
    with np.errstate(all="ignore"):
        row = stats.compare_models_statistically(base, pde)["dice_scores"]
    assert (row["wilcoxon_statistic"], row["wilcoxon_pvalue"], row["improvement"]) == (0.0, 1.0, 0.0)


@pytest.mark.parametrize("study", sorted(jax_studies.ALL_STUDIES))
def test_study_grids_equal_field_by_field(study):
    ours = [dataclasses.asdict(v) for v in studies.ALL_STUDIES[study]()]
    ref = [dataclasses.asdict(v) for v in jax_studies.ALL_STUDIES[study]()]
    assert ours == ref
    assert all(type(a[k]) is type(b[k]) for a, b in zip(ours, ref) for k in a)


def test_ablation_config_fields_and_defaults():
    ours = {f.name: f.default for f in dataclasses.fields(ablation.AblationConfig)}
    ref = {f.name: f.default for f in dataclasses.fields(jax_ablation.AblationConfig)}
    assert ours == ref and len(ours) == 19


_LOSS_FIELDS = ("dice_weight", "bce_weight", "pde_weight", "phase_field_weight", "smooth",
                "diffusion_coeff", "reaction_threshold", "epsilon", "use_reaction_term")


@pytest.mark.parametrize("study", sorted(jax_studies.ALL_STUDIES))
def test_loss_config_of_every_variant_matches_jax(study):
    extra = [ablation.AblationConfig("x", "d", use_pde=True, use_reaction_term=False,
                                     pde_weight=1e-3, phase_field_weight=1e-4)]
    for cfg in studies.ALL_STUDIES[study]() + extra:
        ours = ablation.create_ablation_loss_config(cfg, "torch")
        ref = jax_ablation.create_ablation_loss_config(
            jax_ablation.AblationConfig(**cfg.to_dict()), "pallas")
        assert ours.backend == "torch"
        for f in _LOSS_FIELDS:
            assert getattr(ours, f) == getattr(ref, f), (cfg.name, f)


def _parsed_csv(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


@pytest.mark.parametrize("with_pct", [False, True])
@pytest.mark.parametrize("case", ["random", "nan_pairs", "fewer_than_two_valid"])
def test_comparison_files_match_jax(tmp_path, case, with_pct):
    """The stage-pair CSV and JSON of both packages from the same
    comparison: equal once parsed (and equal text for the CSV)."""
    base, pde = _pair(case, seed=3)
    with np.errstate(all="ignore"):
        comparison = jax_stats.compare_models_statistically(base, pde)
    ablation._comparison_csv(comparison, tmp_path / "ours.csv", "stage1", "stage3", with_pct)
    jax_ablation._comparison_csv(comparison, tmp_path / "ref.csv", "stage1", "stage3", with_pct)
    assert _parsed_csv(tmp_path / "ours.csv") == _parsed_csv(tmp_path / "ref.csv")
    assert (tmp_path / "ours.csv").read_text() == (tmp_path / "ref.csv").read_text()
    ours = ablation._comparison_json(comparison, "stage1", "stage3", with_pct)
    ref = jax_ablation._comparison_json(comparison, "stage1", "stage3", with_pct)
    assert json.dumps(ours, sort_keys=True) == json.dumps(ref, sort_keys=True)


def test_csv_rows_are_written_as_pandas_writes_them(tmp_path):
    rows = [
        {"": "dice_scores", "a": 0.1 + 0.2, "b": np.nan, "c": np.float32(0.6931472),
         "d": True, "e": 5, "f": np.float64(1 / 3), "g": np.bool_(False), "h": 1e-20},
        {"": "iou_scores", "a": 2.0, "b": 0.0, "c": np.float32(0.1), "d": False, "e": 0,
         "f": np.float64(-7.5e16), "g": np.bool_(True), "h": None},
    ]
    save_rows_to_csv(rows, tmp_path / "ours.csv")
    frame = pd.DataFrame(rows).set_index("")
    frame.to_csv(tmp_path / "ref.csv")
    assert (tmp_path / "ours.csv").read_text() == (tmp_path / "ref.csv").read_text()
    save_rows_to_csv(rows, tmp_path / "ours2.csv")
    pd.DataFrame(rows).to_csv(tmp_path / "ref2.csv", index=False)
    assert (tmp_path / "ours2.csv").read_text() == (tmp_path / "ref2.csv").read_text()


@pytest.mark.parametrize("value", [
    np.int64(3), np.float32(0.25), np.bool_(True), np.arange(3), {"a": [np.float64(1.5), (2, 3)]},
    None, "s", 1.0, True, object,
])
def test_make_json_serializable_matches_jax(value):
    assert compare.make_json_serializable(value) == jax_compare.make_json_serializable(value)
    assert type(compare.make_json_serializable(value)) is type(
        jax_compare.make_json_serializable(value))


def test_make_json_serializable_takes_tensors():
    t = torch.tensor([[1.5, 2.0]])
    assert compare.make_json_serializable({"t": t, "b": np.bool_(False)}) == \
        {"t": [[1.5, 2.0]], "b": False}
