"""PyTorch port: TransUNet R50-ViT-B/16 (``models/transunet.py``) against the
benchmark's plain reference (``benchmark/reference/transunet.py``).

At a small size (64² images, hidden 64, 4 heads, MLP 128, 2 layers, one
unit a ResNet block, width 32, decoder (32, 16, 8, 4)): the root gives 32²,
the max pool 15², and the first block's skip is padded to 16², so the
published padding is exercised.  Seeded random weights from the
reference's ``init_params``, loaded into the port by name:

* the forward in ``eval()`` and in training with the same dropout masks,
  the parameter gradients, the BatchNorm running statistics after a step,
  and one ``train_stage`` epoch (its row and the parameters' change after
  AdamW) against ``benchmark/reference/transunet_steps.py``;
* the parameter counts at the published widths; a checkpoint round trip
  with the BatchNorm buffers; ``Predictor(model="transunet")``; the train
  CLI's ``--model``; ``train(model_name="transunet")``; the four spans;
  ``attention_counts``; the U-Net-only paths raising;
* ``build_model``, for each model of ``MODELS``, taking the settings that
  ``train()`` and a ``Predictor`` pass; unknown names and image sizes refused;
* the decoder's channels-last layout (``layout_counts``).
"""

import math
from collections import Counter
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark.drivers.train_stage import program_order
from benchmark.reference import transunet as R
from benchmark.reference import transunet_steps
from physics_informed_image_segmentation_tpu_torch import __main__ as cli
from physics_informed_image_segmentation_tpu_torch.data import DeviceDataset, make_blobs
from physics_informed_image_segmentation_tpu_torch.models import (
    MODELS, TransUNet, UNet, build_model, count_parameters,
)
from physics_informed_image_segmentation_tpu_torch.serve import Predictor
from physics_informed_image_segmentation_tpu_torch.train import (
    LossConfig, create_train_state, make_eval_epoch_fn, make_train_epoch_fn, save_params,
)
from physics_informed_image_segmentation_tpu_torch.train import loop
from physics_informed_image_segmentation_tpu_torch.train.checkpoint import (
    load_params, restore_train_state, save_train_state,
)
from physics_informed_image_segmentation_tpu_torch.train.engine import (
    make_train_chunk_fn, make_train_step_fn, train_stage,
)

S = 64
SMALL = dict(hidden_size=64, num_layers=2, num_heads=4, mlp_dim=128, block_units=(1, 1, 1),
             width=32, decoder_channels=(32, 16, 8, 4))
MODEL = dict(SMALL, dropout=0.1, n_classes=1, batch_size=2)  # the reference's model group
PUBLISHED = dict(hidden_size=768, num_layers=12, num_heads=12, mlp_dim=3072,
                 block_units=(3, 4, 9), width=64, decoder_channels=(256, 128, 64, 16),
                 dropout=0.1, n_classes=1)
OBJ = dict(dice_weight=0.5, bce_weight=0.5, pde_weight=1e-3, phase_field_weight=1e-4,
           diffusion_coeff=5.0, reaction_threshold=0.5, epsilon=0.05)
REPO = Path(__file__).resolve().parents[1]

# Float32, one order of operations against another (the port's nn modules
# and fused attention, the reference's norms from means and variances and
# attention in plain products): 8e-7 measured on the probabilities; a
# bfloat16 reference reads 9.9e-5.
PROB_TOL = 1e-5
# Float64 gradients: the dropout scale is 1/(1-p) rounded to float32 in the
# port and exact in the reference, a relative 1e-8 on the masked values;
# 1.4e-7 measured.  In float32 the ResNet's leaves read up to 2e-2 at this
# size (GroupNorm over one channel of 4x4 pixels amplifies the round-off),
# so gradients are compared in float64.
GRAD_TOL = 1e-6
# BatchNorm running statistics after one step, float32: 6e-8 measured.
BN_TOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module's tests, the previous count after
    it: the suite runs several test processes side by side on one host."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _weights(seed=0, dtype=torch.float32):
    params = R.init_params(R.param_shapes(MODEL, S), torch.Generator().manual_seed(seed), "cpu")
    buffers = R.init_buffers(MODEL, "cpu")
    return ({k: v.to(dtype) for k, v in params.items()},
            {k: v.to(dtype) if v.is_floating_point() else v for k, v in buffers.items()})


def _port(params, buffers, dtype=torch.float32, **kw):
    model = TransUNet(img_size=S, **SMALL, **kw).to(dtype)
    model.load_state_dict({**params, **buffers})
    return model


def _images(n, seed=3):
    return torch.as_tensor(make_blobs(n, S, S, seed=seed)[0]).permute(0, 3, 1, 2).contiguous()


def _leaf_gaps(got, ref, norms=False):
    """Each leaf's gap against the larger of its and the median leaf's norm
    (a leaf whose gradient is 0 in exact arithmetic, as the key's bias under
    softmax, reads round-off alone): the norm of the difference, or with
    ``norms`` the difference of the norms (as ``benchmark/compare.py``)."""
    med = sorted(float(r.norm()) for r in ref)[len(ref) // 2]
    if norms:
        return [abs(float(g.norm()) - float(r.norm())) / max(float(r.norm()), med)
                for g, r in zip(got, ref)]
    return [float((g - r).norm()) / max(float(r.norm()), med) for g, r in zip(got, ref)]


@pytest.mark.parametrize("size, count", [(224, 105_275_921), (1024, 108_271_121)])
def test_parameter_count_at_the_published_widths(size, count):
    model = TransUNet(img_size=size)
    assert count_parameters(model) == count
    shapes = R.param_shapes(PUBLISHED, size)
    assert sum(math.prod(s) for s in shapes.values()) == count
    params = dict(model.named_parameters())
    assert {k: tuple(p.shape) for k, p in params.items()} == {k: tuple(s) for k, s in
                                                             shapes.items()}
    assert {k for k, _ in model.named_buffers()} == set(R.init_buffers(PUBLISHED, "cpu"))


@pytest.mark.parametrize("train", [False, True])
def test_forward_matches_the_reference(train):
    params, buffers = _weights()
    model = _port(params, buffers).train(train)
    x = _images(3)
    with torch.no_grad():
        got = model(x, torch.Generator().manual_seed(5))
        logits, _ = R.forward(params, buffers, x, MODEL, train=train,
                              dropout_generator=torch.Generator().manual_seed(5))
    assert got.dtype == torch.float32 and got.shape == (3, 1, S, S)
    assert float((got - torch.sigmoid(logits)).abs().max()) < PROB_TOL


@pytest.mark.parametrize("train", [False, True])
def test_a_bf16_reference_misses_the_forward_tolerance(train):
    params, buffers = _weights()
    model = _port(params, buffers).train(train)
    x = _images(3)
    with torch.no_grad():
        got = model(x, torch.Generator().manual_seed(5))
        logits, _ = R.forward(params, buffers, x, MODEL, train=train, quant="bf16",
                              dropout_generator=torch.Generator().manual_seed(5))
    assert float((got - torch.sigmoid(logits)).abs().max()) > PROB_TOL


@pytest.mark.parametrize("train", [False, True])
def test_gradients_match_the_reference(train):
    params, buffers = _weights(dtype=torch.float64)
    model = _port(params, buffers, torch.float64).train(train)
    x = _images(3).double()
    t = torch.as_tensor(make_blobs(3, S, S, seed=3)[1][..., 0]).double()
    got = model(x, torch.Generator().manual_seed(5))[:, 0]
    names = [n for n, _ in model.named_parameters()]
    g_port = torch.autograd.grad(((got - t) ** 2).mean(), list(model.parameters()))
    leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
    logits, _ = R.forward(leaves, buffers, x, MODEL, train=train,
                          dropout_generator=torch.Generator().manual_seed(5))
    ref = ((torch.sigmoid(logits[:, 0]) - t) ** 2).mean()
    g_ref = torch.autograd.grad(ref, [leaves[n] for n in names])
    assert max(_leaf_gaps(g_port, g_ref)) < GRAD_TOL


def test_batchnorm_statistics_after_a_training_step():
    params, buffers = _weights()
    model = _port(params, buffers).train()
    x = _images(3)
    model(x, torch.Generator().manual_seed(5))
    _, after = R.forward(params, buffers, x, MODEL, train=True,
                         dropout_generator=torch.Generator().manual_seed(5))
    state = model.state_dict()
    for k, v in after.items():
        if k.endswith("num_batches_tracked"):
            assert int(state[k]) == int(v) == 1
        else:
            assert float((state[k] - v).abs().max()) < BN_TOL, k
            assert not torch.equal(v, buffers[k]), k  # the step moved them


def test_one_train_stage_epoch_matches_the_reference():
    """A Stage II epoch of two steps (batch 2) and its validation pass
    through ``train_stage``, against the reference's replay of the same
    rows, weights and dropout seed."""
    params, buffers = _weights(seed=1)
    images, masks = (torch.as_tensor(a) for a in make_blobs(6, S, S, seed=7))
    train = DeviceDataset(images[:4], masks[:4])
    val = DeviceDataset(images[4:], masks[4:])
    model = _port(params, buffers)
    state = create_train_state(model, 1e-3, 1e-5, dropout_seed=11)
    cfg = LossConfig(**OBJ)
    # On PyTorch's own CPU convolutions, a condition of the test, not of the
    # port (as in test_torch_port_unet.py): at one thread oneDNN's
    # channels-last float32 convolutions, the decoder's, miss the float64
    # result by ten times its NCHW ones (1.2e-5 against 1.0e-6 at 768 input
    # channels), enough to put one pre-ReLU value of the last block on the
    # other side of 0 (1.6e-6 against -4.4e-6).  That pixel moves every
    # gradient by about 1e-3 of its leaf, AdamW's first step turns this into
    # sign flips of lr, and the second step's PDE term then reads 1.8e-4 off
    # the reference; on PyTorch's convolutions it reads 1.6e-6
    with torch.backends.mkldnn.flags(enabled=False):
        _, _, _, rows = train_stage(state, make_train_epoch_fn(cfg), make_eval_epoch_fn(cfg),
                                    train, val, batch_size=2, num_epochs=1,
                                    stage_name="Stage II", shuffle_seed=13, verbose=False)
    order = program_order(4, 13).view(-1, 2)
    epoch = [[(train.images[r], train.masks[r]) for r in order]]
    ref = transunet_steps.train_steps(params, buffers, epoch, (val.images, val.masks), MODEL,
                                      OBJ, {"learning_rate": 1e-3, "weight_decay": 1e-5}, 11,
                                      split=1)
    # float32 round-off through two steps: losses to 1e-5 (6e-7 measured);
    # the metrics of masks thresholded at 0.5 may flip a pixel (none did)
    for key in ("train_loss", "train_pde_loss", "train_phase_field_loss", "val_loss"):
        assert abs(rows[0][key] - ref["rows"][0][key]) <= 1e-5 * abs(ref["rows"][0][key]), key
    for key in ("train_dice_score", "val_dice_score", "val_iou_score"):
        assert abs(rows[0][key] - ref["rows"][0][key]) < 1e-3, key
    # AdamW's first steps move each element by about lr x sign(g), and
    # round-off flips the sign where a gradient is near 0: the change's norm
    # barely moves (4.8e-3 of a leaf's norm at most at one thread, 1.7e-4 at
    # eight, measured), the difference's norm does (up to 3.9e-2), so the
    # norms are compared, as the benchmark does; bf16 reads 3-4.5e-2 on the
    # card.  A leaf whose gradient is round-off (the key's bias) is not counted
    names = [n for n, _ in state.model.named_parameters()]
    change = [p.detach() - params[n] for n, p in zip(names, state.model.parameters())]
    gaps = _leaf_gaps(change, [ref["changes"][n] for n in names], norms=True)
    grad = {n: float(ref["grads"][n].norm()) for n in names}
    floor = 1e-3 * sorted(grad.values())[len(grad) // 2]
    assert max(g for g, n in zip(gaps, names) if grad[n] >= floor) < 0.02
    for k, v in ref["buffers"].items():  # 2.8e-6 measured
        assert torch.allclose(state.model.state_dict()[k].float(), v.float(), atol=1e-5), k


@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("train", [False, True])
def test_decoder_runs_channels_last(train, batch):
    """Every decoder and head convolution and BatchNorm takes a
    channels-last input, training or not, a batch of one too; the
    parameters stay NCHW and the probabilities contiguous."""
    model = TransUNet(img_size=S, **SMALL, generator=torch.Generator().manual_seed(0)).train(train)
    seen = []
    for name, m in [*model.decoder.named_modules(), ("head", model.segmentation_head[0])]:
        if isinstance(m, (torch.nn.Conv2d, torch.nn.BatchNorm2d)):
            m.register_forward_pre_hook(lambda m, args, name=name: seen.append(
                (name, args[0].is_contiguous(memory_format=torch.channels_last))))
    for n in (1, 2):
        with torch.no_grad():
            out = model(_images(batch), torch.Generator().manual_seed(1))
        assert model.layout_counts == {"nhwc": 10 * n, "nchw": 0}
    assert out.shape == (batch, 1, S, S) and out.is_contiguous()
    assert len(seen) == 2 * 19 and all(cl for _, cl in seen), [n for n, cl in seen if not cl]
    assert all(v.is_contiguous() for v in model.state_dict().values())


def test_checkpoints_keep_the_batchnorm_buffers(tmp_path):
    params, buffers = _weights()
    model = _port(params, buffers).train()
    model(_images(2), torch.Generator().manual_seed(1))
    saved = {k: v.clone() for k, v in model.state_dict().items()}
    fresh = load_params(save_params(model, tmp_path / "t.pth"), TransUNet(img_size=S, **SMALL))
    assert all(torch.equal(v, saved[k]) for k, v in fresh.state_dict().items())
    state = create_train_state(model, 1e-3, dropout_seed=3)
    save_train_state(state, tmp_path / "ckpt")
    other = create_train_state(TransUNet(img_size=S, **SMALL), 1e-3, dropout_seed=4)
    restore_train_state(other, tmp_path / "ckpt")
    assert all(torch.equal(v, saved[k]) for k, v in other.model.state_dict().items())
    assert any("running_var" in k for k in saved)


def test_predictor_masks_match_the_reference(tmp_path):
    """At the published widths (64² images: a 4x4 grid of tokens), float32
    on the CPU: the masks equal the reference's logits' signs wherever a
    logit is further than 1e-4 from 0."""
    params = R.init_params(R.param_shapes(PUBLISHED, S), torch.Generator().manual_seed(2), "cpu")
    buffers = R.init_buffers(PUBLISHED, "cpu")
    torch.save({**params, **buffers}, tmp_path / "t.pth")
    pred = Predictor(tmp_path / "t.pth", model="transunet", batch_size=4, image_size=(S, S),
                     precision="f32", device="cpu")
    x = _images(6, seed=4)
    masks = pred.predict(x.permute(0, 2, 3, 1).numpy(), threshold=0.5)
    with torch.no_grad():
        logits, _ = R.forward(params, buffers, x, dict(PUBLISHED), train=False)
    far = logits[:, 0].abs() > 1e-4
    assert far.float().mean() > 0.9
    agree = torch.as_tensor(masks[..., 0] > 0.5) == (logits[:, 0] > 0)
    assert bool(agree[far].all())
    with pytest.raises(ValueError, match="image_size"):
        Predictor(tmp_path / "t.pth", model="transunet", image_size=(S, 2 * S), device="cpu")


@pytest.mark.parametrize("argv, name", [([], "unet"), (["--model", "transunet"], "transunet")])
def test_train_cli_takes_the_model(monkeypatch, argv, name):
    seen = {}
    monkeypatch.setattr(cli, "train", lambda **kw: seen.update(kw))
    cli.main(["--device", "cpu", *argv])
    assert seen["model_name"] == name


def test_train_runs_a_transunet(monkeypatch, tmp_path):
    """``train(model_name="transunet")`` through both stages, at the small
    widths (the published ones hold 105M parameters)."""
    built = []

    def small(name, **kw):
        built.append(name)
        return build_model(name, **kw, **SMALL)

    monkeypatch.setattr(loop, "build_model", small)
    images, masks = make_blobs(6, S, S, seed=5)
    splits = {k: DeviceDataset.from_numpy(images[a:b], masks[a:b], "cpu")
              for k, a, b in (("train_data", 0, 4), ("val_data", 4, 5), ("test_data", 5, 6))}
    out = loop.train(stage1_epochs=1, stage2_epochs=1, batch_size=2, make_plots=False,
                     verbose=False, output_dir=tmp_path, models_dir=tmp_path, device="cpu",
                     precision="f32", model_name="transunet", **splits)
    assert isinstance(out["model"], TransUNet) and built == ["transunet", "transunet"]
    saved = torch.load(tmp_path / "unet_pde_regularized.pth", weights_only=True)
    assert "decoder.conv_more.1.running_var" in saved


def _span_tree(prof) -> Counter:
    tree = Counter()
    for ev in prof.events():
        if ev.name.startswith("piis."):
            parent = ev.cpu_parent
            while parent is not None and not parent.name.startswith("piis."):
                parent = parent.cpu_parent
            tree[(ev.name, parent.name if parent else None)] += 1
    return tree


def test_spans_and_attention_counts_of_a_training_step():
    params, buffers = _weights()
    model = _port(params, buffers)
    state = create_train_state(model, 1e-3, dropout_seed=1)
    step = make_train_step_fn(LossConfig(**OBJ))
    x = _images(2).permute(0, 2, 3, 1)
    y = torch.as_tensor(make_blobs(2, S, S, seed=3)[1])
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(state, x, y, torch.ones(2))
    tree = _span_tree(prof)
    assert tree[("piis.resnet", "piis.forward")] == 1
    assert tree[("piis.transformer", "piis.forward")] == 1
    assert tree[("piis.attention", "piis.transformer")] == SMALL["num_layers"]
    assert tree[("piis.decoder", "piis.forward")] == 1
    tokens = (S // 16) ** 2
    assert model.attention_counts == {
        "calls": SMALL["num_layers"],
        "pairs": SMALL["num_layers"] * 2 * SMALL["num_heads"] * tokens * tokens}


def _sweep(model):
    from physics_informed_image_segmentation_tpu_torch.experiments.sweep import run_batched_sweep

    run_batched_sweep(model, {}, {}, None, None, num_epochs=1, batch_size=2, learning_rate=1e-3)


def _sharded(model):
    from physics_informed_image_segmentation_tpu_torch.parallel.spatial_unet import (
        sharded_forward_nhwc,
    )

    sharded_forward_nhwc(model, torch.zeros(1, S, S, 1), "f32", None, None, spatial=True)


def _chunks(model):
    state = create_train_state(model, 1e-3)
    make_train_chunk_fn(LossConfig())(state, None, None, torch.ones(1, 2))


def _msgpack(model):
    load_params(REPO / "tests/torch_port_data/unet_b4_f32.msgpack", model)


@pytest.mark.parametrize("path", [_sweep, _sharded, _chunks, _msgpack])
def test_unet_only_paths_refuse_a_transunet(path):
    with pytest.raises(ValueError, match="U-Net only"):
        path(TransUNet(img_size=S, **SMALL))


def test_build_model_by_name():
    assert isinstance(build_model("unet", image_size=S, base_channels=4), UNet)
    assert isinstance(build_model("transunet", image_size=S, **SMALL), TransUNet)
    with pytest.raises(ValueError, match="unknown model"):
        build_model("vit", image_size=S)
    with pytest.raises(ValueError, match="multiple of 16"):
        TransUNet(img_size=72)


class _Built(Exception):
    """Raised by a recording constructor once it has taken its arguments."""


# Each model's image side and small widths here (the Swin-Unet's side is a
# multiple of 224), and what its constructor takes of the run's settings,
# from train() (base 4, "torch" init) and from a Predictor (base 4; the
# default init).
SIDES = {"unet": S, "transunet": S, "swinunet": 224}
WIDTHS = {"unet": {}, "transunet": SMALL, "swinunet": dict(embed_dim=24, num_heads=(1, 2, 4, 8))}
TAKES = {"unet": (dict(base_channels=4, param_init="torch"),
                  dict(base_channels=4, param_init="lecun")),
         "transunet": (dict(img_size=S), dict(img_size=S)),
         "swinunet": (dict(img_size=224), dict(img_size=224))}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_build_model_maps_the_run_settings(monkeypatch, tmp_path, name):
    """``build_model`` alone maps a run's settings to each model: the model
    has the registered type, and ``train()`` and a ``Predictor`` hand it the
    same settings, which reach the constructor as ``TAKES`` says."""
    side = SIDES[name]
    model = build_model(name, image_size=side, base_channels=4, param_init="torch",
                        generator=torch.Generator().manual_seed(0), **WIDTHS[name])
    assert type(model) is MODELS[name] and getattr(model, "img_size", side) == side

    seen = []

    def record(**kw):
        seen.append(kw)
        raise _Built

    monkeypatch.setitem(MODELS, name, record)
    images, masks = make_blobs(2, side, side, seed=0)
    data = DeviceDataset.from_numpy(images, masks, "cpu")
    with pytest.raises(_Built):
        loop.train(train_data=data, val_data=data, output_dir=tmp_path, models_dir=tmp_path,
                   device="cpu", precision="f32", make_plots=False, verbose=False,
                   base_channels=4, param_init="torch", model_name=name)
    with pytest.raises(_Built):
        Predictor(tmp_path / "absent.pth", model=name, image_size=(side, side), base_channels=4,
                  device="cpu")
    assert isinstance(seen[0].pop("generator"), torch.Generator)
    assert seen[1].pop("generator") is None
    assert tuple(seen) == TAKES[name]


@pytest.mark.parametrize("make, match", [
    (lambda path: Predictor(path, model="vit", device="cpu"), "unknown model"),
    (lambda path: Predictor(path, model=TransUNet(img_size=S, **SMALL), image_size=(2 * S, 2 * S),
                            device="cpu"), "image_size"),
], ids=["unknown-name", "instance-side"])
def test_predictor_refuses_a_model(tmp_path, make, match):
    """A Predictor given an unknown name, or a built model whose side is not
    ``image_size``, raises before any weights are read (a named model's side:
    ``test_predictor_masks_match_the_reference``)."""
    with pytest.raises(ValueError, match=match):
        make(tmp_path / "absent.pth")
