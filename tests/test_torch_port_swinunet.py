"""PyTorch port: Swin-Unet, Swin-T with window 7 (``models/swin_unet.py``),
against the benchmark's plain reference (``benchmark/reference/swin_unet.py``).

At a small width (224² images, embed_dim 24, heads (1, 2, 4, 8), the
published depths, window 7 and drop-path rate 0.2): the stages' sides are
56, 28, 14 and 7, so the first three stages shift their odd blocks and the
last, whose side equals the window, takes one window and no shift, as the
published rule has it.  Seeded random weights from the reference's
``init_params``, loaded into the port by name:

* the logits in ``eval()`` and in training with the same drop-path masks,
  every parameter's gradient (the bias tables' too), and one
  ``train_stage`` epoch (its row and the parameters' change after AdamW)
  against ``benchmark/reference/swinunet_steps.py``; the reference without
  the shift mask, without the relative-position bias or without the roll
  misses those tolerances;
* the shift mask against a 14×14 map checked by hand; the relative-position
  index against the reference's;
* the parameter count at the published widths; ``build_model`` and its
  refusal of a side that is not a multiple of 224; ``Predictor(model=
  "swinunet")``; the train CLI's ``--model``; ``train(model_name=
  "swinunet")`` through both stages, and the side it reads images at; the
  spans; the counters; the U-Net-only paths raising.
"""

import math
from collections import Counter
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark.drivers.train_stage import program_order
from benchmark.reference import swin_unet as R
from benchmark.reference import swinunet_steps
from physics_informed_image_segmentation_tpu_torch import __main__ as cli
from physics_informed_image_segmentation_tpu_torch.data import DeviceDataset, make_blobs
from physics_informed_image_segmentation_tpu_torch.models import (
    MODELS, SwinUnet, build_model, count_parameters, data_side,
)
from physics_informed_image_segmentation_tpu_torch.models import swin_unet as S
from physics_informed_image_segmentation_tpu_torch.serve import Predictor
from physics_informed_image_segmentation_tpu_torch.train import (
    LossConfig, create_train_state, make_eval_epoch_fn, make_train_epoch_fn,
)
from physics_informed_image_segmentation_tpu_torch.train import loop
from physics_informed_image_segmentation_tpu_torch.train.checkpoint import load_params
from physics_informed_image_segmentation_tpu_torch.train.engine import (
    make_train_chunk_fn, make_train_step_fn, train_stage,
)

SIDE = 224
SMALL = dict(embed_dim=24, num_heads=(1, 2, 4, 8))
MODEL = dict(embed_dim=24, depths=[2, 2, 2, 2], num_heads=[1, 2, 4, 8], window_size=7,
             patch_size=4, mlp_ratio=4.0, drop_path_rate=0.2, n_classes=1, batch_size=2)
PUBLISHED = dict(MODEL, embed_dim=96, num_heads=[3, 6, 12, 24])
OBJ = dict(dice_weight=0.5, bce_weight=0.5, pde_weight=1e-3, phase_field_weight=1e-4,
           diffusion_coeff=5.0, reaction_threshold=0.5, epsilon=0.05)
REPO = Path(__file__).resolve().parents[1]

# Float32, one order of operations against another (nn.LayerNorm against
# means and variances, the bias added to the scaled product once in the
# port and in two adds in the reference, the bias padded in the port):
# 8.6e-7 measured on the probabilities; a bfloat16 reference reads 8.5e-3.
PROB_TOL = 1e-5
# Float32 gradients, each leaf's difference against the larger of its and
# the median leaf's norm: 1.8e-6 measured (the x4 expansion's LayerNorm
# weight, whose gradient sums over every pixel); in float64 both sides
# agree to 3e-15, so the gap is round-off.  A reference without the mask
# reads 2.7e-2.
GRAD_TOL = 2e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module's tests, the previous count after
    it: the suite runs several test processes side by side on one host."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _weights(seed=0, dtype=torch.float32):
    params = R.init_params(R.param_shapes(MODEL, SIDE), torch.Generator().manual_seed(seed),
                           "cpu")
    return {k: v.to(dtype) for k, v in params.items()}


def _port(params, dtype=torch.float32):
    model = SwinUnet(img_size=SIDE, **SMALL).to(dtype)
    missing, unexpected = model.load_state_dict(params, strict=False)
    assert not unexpected and all(k.endswith(("relative_position_index", "attn_mask"))
                                  for k in missing)
    return model


def _images(n, seed=3):
    return torch.as_tensor(make_blobs(n, SIDE, SIDE, seed=seed)[0]).permute(0, 3, 1, 2).contiguous()


def _leaf_gaps(got, ref, norms=False):
    """Each leaf's gap against the larger of its and the median leaf's norm:
    the norm of the difference, or with ``norms`` the difference of the
    norms (as ``benchmark/compare.py``)."""
    med = sorted(float(r.norm()) for r in ref)[len(ref) // 2]
    if norms:
        return [abs(float(g.norm()) - float(r.norm())) / max(float(r.norm()), med)
                for g, r in zip(got, ref)]
    return [float((g - r).norm()) / max(float(r.norm()), med) for g, r in zip(got, ref)]


def _forward_gap(train, params=None, model=None):
    params = params or _weights()
    model = (model or _port(params)).train(train)
    x = _images(2)
    with torch.no_grad():
        got = model(x, torch.Generator().manual_seed(5))
        ref = R.forward(params, x, MODEL, train=train,
                        drop_path_generator=torch.Generator().manual_seed(5))
    assert got.dtype == torch.float32 and got.shape == (2, 1, SIDE, SIDE)
    return float((got - torch.sigmoid(ref)).abs().max())


@pytest.mark.parametrize("size, shifted", [(224, 6), (896, 7)])
def test_parameter_count_at_the_published_widths(size, shifted):
    model = SwinUnet(img_size=size)
    assert count_parameters(model) == 27_168_132
    shapes = R.param_shapes(PUBLISHED, size)
    assert sum(math.prod(s) for s in shapes.values()) == 27_168_132
    assert [(k, tuple(p.shape)) for k, p in model.named_parameters()] == [
        (k, tuple(s)) for k, s in shapes.items()]
    buffers = {k for k, _ in model.named_buffers()}
    assert len([k for k in buffers if k.endswith("relative_position_index")]) == 14
    # the odd block of each stage wider than a window (three at 224², whose
    # last stage is 7², four at 896²), in the encoder; three in the decoder
    assert len([k for k in buffers if k.endswith("attn_mask")]) == shifted


@pytest.mark.parametrize("train", [False, True])
def test_forward_matches_the_reference(train):
    assert _forward_gap(train) < PROB_TOL


def test_a_bf16_reference_misses_the_forward_tolerance():
    params = _weights()
    model = _port(params).eval()
    x = _images(2)
    with torch.no_grad():
        got = model(x)
        ref = R.forward(params, x, MODEL, train=False, quant="bf16")
    assert float((got - torch.sigmoid(ref)).abs().max()) > PROB_TOL


def _no_mask(monkeypatch):
    monkeypatch.setattr(R, "region_mask", lambda side, w, s: torch.zeros(
        (side // w) ** 2, w * w, w * w))


def _no_bias(monkeypatch):
    monkeypatch.setattr(R, "_relative_bias", lambda table, w: torch.zeros(
        table.shape[1], w * w, w * w, dtype=table.dtype))


def _no_roll(monkeypatch):
    monkeypatch.setattr(R, "_roll", lambda x, s: x)


@pytest.mark.parametrize("fault", [_no_mask, _no_bias, _no_roll],
                         ids=["no-mask", "no-bias", "no-roll"])
def test_the_reference_without_a_part_of_the_window_attention_misses(monkeypatch, fault):
    """The reference without the shift mask M, without the relative-position
    bias B, or without the cyclic roll gives probabilities and gradients
    outside the tolerances the port meets (1.2e-3 to 3.3e-2 on the
    probabilities, 1.5e-2 to 6.6e-2 on the gradients, measured): each part
    is computed, and where the published model computes it."""
    params = _weights()
    model = _port(params)
    assert _forward_gap(False, params, model) < PROB_TOL
    fault(monkeypatch)
    assert _forward_gap(False, params, model) > 100 * PROB_TOL
    assert max(_gradient_gaps(True, params)[0].values()) > 100 * GRAD_TOL


def _gradient_gaps(train, params):
    """Each leaf's gap of the port's gradient against the reference's (a
    leaf the reference does not use reads a gradient of 0), and the
    reference's gradients."""
    model = _port(params).train(train)
    x = _images(2)
    t = torch.as_tensor(make_blobs(2, SIDE, SIDE, seed=3)[1][..., 0])
    got = model(x, torch.Generator().manual_seed(5))[:, 0]
    names = [n for n, _ in model.named_parameters()]
    g_port = torch.autograd.grad(((got - t) ** 2).mean(), list(model.parameters()))
    leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
    logits = R.forward(leaves, x, MODEL, train=train,
                       drop_path_generator=torch.Generator().manual_seed(5))
    ref = ((torch.sigmoid(logits[:, 0]) - t) ** 2).mean()
    g_ref = torch.autograd.grad(ref, [leaves[n] for n in names], allow_unused=True)
    g_ref = [torch.zeros_like(leaves[n]) if g is None else g for n, g in zip(names, g_ref)]
    return dict(zip(names, _leaf_gaps(g_port, g_ref))), dict(zip(names, g_ref))


@pytest.mark.parametrize("train", [False, True])
def test_gradients_match_the_reference(train):
    gaps, ref = _gradient_gaps(train, _weights())
    assert max(gaps.values()) < GRAD_TOL
    tables = [n for n in ref if n.endswith("relative_position_bias_table")]
    assert len(tables) == 14 and all(float(ref[n].norm()) > 0 for n in tables)


def test_shift_mask_on_a_14x14_map():
    """A 14×14 map, window 7, shift 3: after the roll by −3, rows (and
    columns) 0–6 come from region 0, 7–10 from region 1, 11–13 from region
    2 (the last three wrapped round from the top).  Window (0, 0) lies in
    one region; window (0, 1) in two column bands of 4 and 3 columns, so
    2 · 28 · 21 pairs are masked; window (1, 1) in four blocks of 16, 12,
    12 and 9 tokens, so 49² − (16² + 12² + 12² + 9²) = 1776 are; window
    (1, 0) as (0, 1) by rows."""
    mask = S.shift_mask(14, 7, 3)
    assert mask.shape == (4, 49, 49)
    assert set(mask.unique().tolist()) == {-100.0, 0.0}
    assert [int((m != 0).sum()) for m in mask] == [0, 2 * 28 * 21, 2 * 28 * 21, 1776]

    def region(i):
        return 0 if i < 7 else (1 if i < 11 else 2)

    for win, (r0, c0) in enumerate([(0, 0), (0, 7), (7, 0), (7, 7)]):
        label = [3 * region(r0 + t // 7) + region(c0 + t % 7) for t in range(49)]
        want = torch.tensor([[0.0 if a == b else -100.0 for b in label] for a in label])
        assert torch.equal(mask[win], want)
    assert torch.equal(mask, R.region_mask(14, 7, 3))
    block = SwinUnet(img_size=448).swin_unet.layers[3].blocks[1]  # 14×14 at 448²
    assert block.shift_size == 3 and torch.equal(block.attn_mask, mask)


def test_relative_position_index_and_window_rule():
    """The index follows the reference's pair by pair; a stage as wide as
    the window takes one window and no shift, a wider one shifts its odd
    blocks by half a window."""
    for w in (2, 7):
        assert torch.equal(S.relative_position_index(w), R.relative_index(w))
    assert int(S.relative_position_index(7).max()) == 13 * 13 - 1
    net = SwinUnet(img_size=SIDE, **SMALL).swin_unet
    last = net.layers[3].blocks[1]
    assert (last.window_size, last.shift_size, last.attn_mask) == (7, 0, None)
    assert [layer.blocks[1].shift_size for layer in net.layers[:3]] == [3, 3, 3]
    x = torch.randn(2, 4, 4, 3)
    windows = S.window_partition(x, 2)
    assert torch.equal(windows[1], x[0, :2, 2:]) and torch.equal(S.window_reverse(windows, 2, 4,
                                                                                   4), x)


def test_counts_of_one_forward():
    """Fourteen calls a forward: 8 encoder blocks, 6 decoder blocks; pairs
    and windows from the stages' sides 56, 28, 14, 7."""
    model = SwinUnet(img_size=SIDE, **SMALL, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        model(_images(2))
    per_stage = [(56, 1), (28, 2), (14, 4), (7, 8)]  # (side, heads)
    calls = [0, 0, 1, 1, 2, 2, 3, 3, 2, 2, 1, 1, 0, 0]
    windows = sum((per_stage[i][0] // 7) ** 2 for i in calls)
    assert model.attention_counts == {
        "calls": 14, "pairs": 2 * sum((per_stage[i][0] // 7) ** 2 * per_stage[i][1] * 49 ** 2
                                      for i in calls)}
    assert model.window_counts == {"windows": 2 * windows, "shifted": 6}


def test_one_train_stage_epoch_matches_the_reference():
    """A Stage II epoch of two steps (batch 2) and its validation pass
    through ``train_stage``, against the reference's replay of the same
    rows, weights and drop-path seed."""
    params = _weights(seed=1)
    images, masks = (torch.as_tensor(a) for a in make_blobs(6, SIDE, SIDE, seed=7))
    train = DeviceDataset(images[:4], masks[:4])
    val = DeviceDataset(images[4:], masks[4:])
    model = _port(params)
    state = create_train_state(model, 1e-3, 1e-5, dropout_seed=11)
    cfg = LossConfig(**OBJ)
    _, _, _, rows = train_stage(state, make_train_epoch_fn(cfg), make_eval_epoch_fn(cfg),
                                train, val, batch_size=2, num_epochs=1, stage_name="Stage II",
                                shuffle_seed=13, verbose=False)
    order = program_order(4, 13).view(-1, 2)
    epoch = [[(train.images[r], train.masks[r]) for r in order]]
    ref = swinunet_steps.train_steps(params, epoch, (val.images, val.masks), MODEL, OBJ,
                                     {"learning_rate": 1e-3, "weight_decay": 1e-5}, 11, split=1)
    # float32 round-off through two steps: losses to 1e-5 (4e-7 measured);
    # the metrics of masks thresholded at 0.5 may flip a pixel (none did)
    for key in ("train_loss", "train_pde_loss", "train_phase_field_loss", "val_loss"):
        assert abs(rows[0][key] - ref["rows"][0][key]) <= 1e-5 * abs(ref["rows"][0][key]), key
    for key in ("train_dice_score", "val_dice_score", "val_iou_score"):
        assert abs(rows[0][key] - ref["rows"][0][key]) < 1e-3, key
    # AdamW's first steps move each element by about lr x sign(g): the
    # change's norms are compared, as the benchmark does (3e-5 measured); a
    # leaf whose gradient is round-off is not counted
    names = [n for n, _ in state.model.named_parameters()]
    change = [p.detach() - params[n] for n, p in zip(names, state.model.parameters())]
    gaps = _leaf_gaps(change, [ref["changes"][n] for n in names], norms=True)
    grad = {n: float(ref["grads"][n].norm()) for n in names}
    floor = 1e-3 * sorted(grad.values())[len(grad) // 2]
    assert max(g for g, n in zip(gaps, names) if grad[n] >= floor) < 1e-3


def _span_tree(prof) -> Counter:
    tree = Counter()
    for ev in prof.events():
        if ev.name.startswith("piis."):
            parent = ev.cpu_parent
            while parent is not None and not parent.name.startswith("piis."):
                parent = parent.cpu_parent
            tree[(ev.name, parent.name if parent else None)] += 1
    return tree


def test_spans_of_a_training_step():
    """piis.transformer and piis.decoder inside piis.forward; in them, two
    piis.window spans and one piis.attention a block, and piis.resample
    around each merging (3, encoder) and expansion (3 + the x4, decoder)."""
    model = _port(_weights())
    state = create_train_state(model, 1e-3, dropout_seed=1)
    step = make_train_step_fn(LossConfig(**OBJ))
    x = _images(2).permute(0, 2, 3, 1)
    y = torch.as_tensor(make_blobs(2, SIDE, SIDE, seed=3)[1])
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(state, x, y, torch.ones(2))
    tree = _span_tree(prof)
    assert tree[("piis.transformer", "piis.forward")] == 1
    assert tree[("piis.decoder", "piis.forward")] == 1
    assert tree[("piis.attention", "piis.transformer")] == 8
    assert tree[("piis.attention", "piis.decoder")] == 6
    assert tree[("piis.window", "piis.transformer")] == 16
    assert tree[("piis.window", "piis.decoder")] == 12
    assert tree[("piis.resample", "piis.transformer")] == 3
    assert tree[("piis.resample", "piis.decoder")] == 4
    assert sum(n for (name, _), n in tree.items() if name == "piis.resample") == 7


def test_build_model_and_its_refusals():
    model = build_model("swinunet", image_size=SIDE, **SMALL)
    assert isinstance(model, SwinUnet) and model.img_size == SIDE
    for side in (256, 112, 1024):
        with pytest.raises(ValueError, match="multiple of 224"):
            build_model("swinunet", image_size=side)


def test_predictor_masks_match_the_reference(tmp_path):
    """At its built size (224², float32 on the CPU, the small widths): the
    masks equal the reference's logits' signs wherever a logit is further
    than 1e-4 from 0.  A built model given another size, and a named one
    given a side that is not a multiple of 224, are refused before any
    weights are read."""
    params = _weights(seed=2)
    torch.save(_port(params).state_dict(), tmp_path / "s.pth")
    pred = Predictor(tmp_path / "s.pth", model=SwinUnet(img_size=SIDE, **SMALL), batch_size=2,
                     image_size=(SIDE, SIDE), precision="f32", device="cpu")
    x = _images(3, seed=4)
    masks = pred.predict(x.permute(0, 2, 3, 1).numpy(), threshold=0.5)
    with torch.no_grad():
        logits = R.forward(params, x, MODEL, train=False)
    far = logits[:, 0].abs() > 1e-4
    assert far.float().mean() > 0.9
    agree = torch.as_tensor(masks[..., 0] > 0.5) == (logits[:, 0] > 0)
    assert bool(agree[far].all())
    with pytest.raises(ValueError, match="image_size"):
        Predictor(tmp_path / "absent.pth", model=SwinUnet(img_size=SIDE, **SMALL),
                  image_size=(2 * SIDE, 2 * SIDE), device="cpu")
    with pytest.raises(ValueError, match="multiple of 224"):
        Predictor(tmp_path / "absent.pth", model="swinunet", image_size=(256, 256), device="cpu")


def test_train_runs_a_swinunet(monkeypatch, tmp_path):
    """``train(model_name="swinunet")`` through both stages, at the small
    widths, and its checkpoint served back."""
    built = []

    def small(name, **kw):
        built.append(name)
        return build_model(name, **kw, **SMALL)

    monkeypatch.setattr(loop, "build_model", small)
    images, masks = make_blobs(6, SIDE, SIDE, seed=5)
    splits = {k: DeviceDataset.from_numpy(images[a:b], masks[a:b], "cpu")
              for k, a, b in (("train_data", 0, 4), ("val_data", 4, 5), ("test_data", 5, 6))}
    out = loop.train(stage1_epochs=1, stage2_epochs=1, batch_size=2, make_plots=False,
                     verbose=False, output_dir=tmp_path, models_dir=tmp_path, device="cpu",
                     precision="f32", model_name="swinunet", **splits)
    assert isinstance(out["model"], SwinUnet) and built == ["swinunet", "swinunet"]
    pred = Predictor(tmp_path / "unet_pde_regularized.pth", model=SwinUnet(img_size=SIDE, **SMALL),
                     batch_size=2, image_size=(SIDE, SIDE), precision="f32", device="cpu")
    assert pred.predict(images[:1]).shape == (1, SIDE, SIDE, 1)


class _Read(Exception):
    """Raised by a recording loader once it has taken its arguments."""


def test_each_model_has_a_data_side():
    """The models layer gives every model the side that images read from
    disk take: the reference's 128, or the Swin-Unet's side unit, patch ×
    window × 2^(stages − 1); an unknown name has none."""
    assert {name: data_side(name) for name in MODELS} == {"unet": 128, "transunet": 128,
                                                           "swinunet": 224}
    assert SwinUnet.side_unit() == 224 and SwinUnet.side_unit(4, 7, 3) == 112
    with pytest.raises(ValueError, match="unknown model"):
        data_side("vit")


@pytest.mark.parametrize("name, side", [("unet", 128), ("transunet", 128), ("swinunet", 224)])
def test_train_reads_images_at_a_side_the_model_takes(monkeypatch, tmp_path, name, side):
    """From a data root, ``train()`` reads images at the reference's 128², or
    at 224² for a Swin-Unet, whose side is a multiple of 224."""
    sizes = []

    def load(image_dir, annotation_file, device, image_size=(128, 128)):
        sizes.append(tuple(image_size))
        raise _Read

    monkeypatch.setattr(loop, "load_device_dataset", load)
    with pytest.raises(_Read):
        loop.train(data_root=tmp_path, device="cpu", model_name=name, make_plots=False,
                   verbose=False)
    assert sizes == [(side, side)]


def test_train_cli_takes_swinunet(monkeypatch):
    seen = {}
    monkeypatch.setattr(cli, "train", lambda **kw: seen.update(kw))
    cli.main(["--device", "cpu", "--model", "swinunet"])
    assert seen["model_name"] == "swinunet"


def _sweep(model):
    from physics_informed_image_segmentation_tpu_torch.experiments.sweep import run_batched_sweep

    run_batched_sweep(model, {}, {}, None, None, num_epochs=1, batch_size=2, learning_rate=1e-3)


def _sharded(model):
    from physics_informed_image_segmentation_tpu_torch.parallel.spatial_unet import (
        sharded_forward_nhwc,
    )

    sharded_forward_nhwc(model, torch.zeros(1, SIDE, SIDE, 1), "f32", None, None, spatial=True)


def _chunks(model):
    state = create_train_state(model, 1e-3)
    make_train_chunk_fn(LossConfig())(state, None, None, torch.ones(1, 2))


def _msgpack(model):
    load_params(REPO / "tests/torch_port_data/unet_b4_f32.msgpack", model)


@pytest.mark.parametrize("path", [_sweep, _sharded, _chunks, _msgpack])
def test_unet_only_paths_refuse_a_swinunet(path):
    with pytest.raises(ValueError, match="U-Net only"):
        path(SwinUnet(img_size=SIDE, **SMALL))
