"""The plain reference against the port, at a tiny size on the CPU, and the
control: the reference in fp8 in the program's place fails the check."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark import inputs
from benchmark import run as R
from benchmark.calibrate import readings
from benchmark.compare import verdict
from benchmark.reference import adamw, objective, unet
from physics_informed_image_segmentation_tpu_torch.models import UNet
from physics_informed_image_segmentation_tpu_torch.ops import losses, metrics
from physics_informed_image_segmentation_tpu_torch.train import AdamW

from .tiny import make_root

MODEL = {"base_channels": 4, "in_channels": 1, "out_channels": 1, "dropout": 0.2}
OBJ = {"dice_weight": 0.5, "bce_weight": 0.5, "pde_weight": 1e-4, "phase_field_weight": 1e-4,
       "diffusion_coeff": 5.0, "reaction_threshold": 0.5, "epsilon": 0.05}


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _data(n=4, size=32, seed=3):
    gen = torch.Generator().manual_seed(seed)
    x, t = inputs.blobs(n, size, gen, "cpu")
    return x, t, inputs.weights(MODEL, gen, "cpu")


@pytest.mark.parametrize("train", [False, True])
def test_forward_matches_the_port(train):
    x, _, params = _data()
    model = UNet(base_channels=4)
    model.load_state_dict(params)
    model.train(train)
    g1, g2 = torch.Generator().manual_seed(9), torch.Generator().manual_seed(9)
    with torch.no_grad():
        ours = unet.forward(params, x.permute(0, 3, 1, 2), base=4, generator=g1, train=train)
        theirs = model(x.permute(0, 3, 1, 2), g2)
    torch.testing.assert_close(ours, theirs, rtol=1e-5, atol=1e-6)


def test_objective_and_metrics_match_the_port():
    x, t, params = _data()
    with torch.no_grad():
        p = unet.forward(params, x.permute(0, 3, 1, 2), base=4)[:, 0]
    comps = losses.loss_components(p, t[..., 0], pde_weight=1e-4, phase_field_weight=1e-4,
                                   diffusion_coeff=5.0, reaction_threshold=0.5, epsilon=0.05)
    port = 0.5 * comps["dice_loss"] + 0.5 * comps["bce_loss"] + 1e-4 * (
        comps["pde_loss"] + comps["phase_field_loss"])
    total, phys = objective.objective(p, t[..., 0], OBJ)
    torch.testing.assert_close(total, port, rtol=1e-6, atol=0)
    for k in ("pde_loss", "phase_field_loss"):
        torch.testing.assert_close(phys[k], comps[k], rtol=1e-5, atol=0)
    # a map with pixels on both sides of the threshold, against the masks
    q = torch.rand(t[..., 0].shape, generator=torch.Generator().manual_seed(1))
    ours = objective.batch_metrics(q, t[..., 0])
    torch.testing.assert_close(ours["dice"], metrics.dice_score_per_sample(q, t[..., 0]))
    torch.testing.assert_close(ours["iou"], metrics.iou_score_per_sample(q, t[..., 0]))
    torch.testing.assert_close(ours["bf1"], metrics.boundary_f1_per_sample(q, t[..., 0]))
    torch.testing.assert_close(ours["global_dice"], metrics.dice_score(q, t[..., 0]))


def test_adamw_matches_the_port():
    rng = np.random.default_rng(0)
    p0 = {f"w{i}": torch.tensor(rng.normal(size=(3, 5)), dtype=torch.float32) for i in range(3)}
    ours = {k: v.clone() for k, v in p0.items()}
    theirs = [v.clone() for v in p0.values()]
    a, b = adamw.AdamW(ours, 1e-3, 1e-5), AdamW(theirs, 1e-3, 1e-5)
    for _ in range(3):
        g = [torch.tensor(rng.normal(size=(3, 5)), dtype=torch.float32) for _ in range(3)]
        a.step(dict(zip(ours, g)))
        b.step(g)
    for k, t in zip(ours, theirs):
        torch.testing.assert_close(ours[k], t, rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("cell", ["tiny-train", "tiny-predict"])
def test_program_passes_and_the_fp8_control_separates(tmp_path, cell):
    """The port in float32 reads far under every limit of the cell it
    stands for; with the port in bf16, as the configuration states, the
    reference in fp8 put in its place reads three times its gap or more on
    one of the compared numbers, as on the card at the cell's size."""
    f32 = R.load_cell(cell, make_root(tmp_path / "f32", "f32"))
    got = readings(f32, 2 ** 31 + 7, control=False, fault=False, device="cpu")
    ok, _ = verdict(got["program"], f32.limits)
    assert ok, got
    assert all(got["program"][k] < 0.1 * lim for k, lim in f32.limits.items()), got
    bf16 = R.load_cell(cell, make_root(tmp_path / "bf16", "bf16"))
    got = readings(bf16, 2 ** 31 + 7, control=True, fault=False, device="cpu")
    assert any(got["fp8"][k] >= 3 * got["program"][k] for k in bf16.limits), got
