"""PyTorch port: the serving path (``Predictor``, the ``predict`` CLI) held
against the JAX package's on the same weights and the same numpy images.

The weights are made with numpy from the JAX model's parameter tree,
written as a ``.msgpack`` for the JAX Predictor and, carried over by
``state_dict_from_jax``, as a ``.pth`` for the port's.  Both run on the
CPU, U-Net base 4, 32x32, float32 unless a test says otherwise.

Tolerances: float32 forward 2e-6 absolute (the bar of
``tests/test_torch_interop.py``); tiled inference 1e-5 (a weighted mean of
such forwards); bf16 against JAX's bf16 2e-3 absolute on probabilities
(both round to bf16 after every layer, but XLA's and PyTorch's CPU
convolutions accumulate differently before that rounding, so a value can
land on the neighbouring bf16; measured 2.1e-4 here, as far as either is
from its own float32 answer).
"""

import runpy
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from physics_informed_image_segmentation_tpu.models import UNet as JaxUNet
from physics_informed_image_segmentation_tpu.serve import Predictor as JaxPredictor
from physics_informed_image_segmentation_tpu.train import save_params as jax_save_params
from physics_informed_image_segmentation_tpu_torch import predict as predict_cli
from physics_informed_image_segmentation_tpu_torch.data import make_blobs
from physics_informed_image_segmentation_tpu_torch.models import UNet
from physics_informed_image_segmentation_tpu_torch.serve import (
    Predictor,
    _d4_apply,
    _d4_invert,
    load_image_for_inference,
)
from physics_informed_image_segmentation_tpu_torch.train.checkpoint import save_params
from physics_informed_image_segmentation_tpu_torch.utils.weights import state_dict_from_jax

REPO = Path(__file__).resolve().parent.parent
HW = 32
FWD_ATOL = 2e-6


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module's tests, the previous count after
    it: the suite runs several test processes side by side on one host."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _write_checkpoints(directory, base_channels, seed):
    """The same random weights as ``model.msgpack`` and ``model.pth``."""
    jmodel = JaxUNet(base_channels=base_channels, dtype=jnp.float32)
    template = jmodel.init(jax.random.key(0), jnp.zeros((1, HW, HW, 1), jnp.float32))
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(a.shape)).astype(np.float32),
        template)
    jax_save_params(params, directory / "model.msgpack")
    torch.save(state_dict_from_jax(params), directory / "model.pth")
    return params


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    directory = tmp_path_factory.mktemp("ckpt")
    _write_checkpoints(directory, 4, seed=0)
    return directory


def _pair(ckpt, precision="f32", batch_size=4):
    kw = dict(batch_size=batch_size, image_size=(HW, HW), precision=precision, base_channels=4)
    return (JaxPredictor(ckpt / "model.msgpack", **kw),
            Predictor(ckpt / "model.pth", device="cpu", **kw))


@pytest.fixture(scope="module")
def pair(ckpt):
    return _pair(ckpt)


def _images(n, seed, h=HW, w=HW):
    return make_blobs(n, h, w, seed=seed)[0]


@pytest.mark.parametrize("n", [3, 8, 11])
def test_predict_matches_jax(pair, n):
    jp, p = pair
    images = _images(n, seed=n)
    probs = p.predict(images)
    assert probs.shape == (n, HW, HW, 1) and probs.dtype == np.float32
    assert (probs > 0).all() and (probs < 1).all()
    np.testing.assert_allclose(probs, jp.predict(images), atol=FWD_ATOL, rtol=0)
    # (N, H, W) input means the same
    np.testing.assert_array_equal(p.predict(images[..., 0]), probs)


def test_threshold_binarizes_and_padding_changes_nothing(pair):
    _, p = pair
    images = _images(3, seed=1)
    probs = p.predict(images)
    masks = p.predict(images, threshold=0.5)
    assert masks.dtype == np.float32 and set(np.unique(masks)) <= {0.0, 1.0}
    np.testing.assert_array_equal(masks, (probs > 0.5).astype(np.float32))
    np.testing.assert_array_equal(p.predict(images, threshold=1.0), np.zeros_like(probs))
    # 3 images are padded with one zero image, 2 with two: the same answers
    np.testing.assert_allclose(probs[:2], p.predict(images[:2]), atol=1e-6, rtol=0)


B = 4  # the batch of ``pair``'s Predictors


def _parent_path(p, images, tta=False):
    """The output path before the ring, chunk for chunk as it ran (the
    CPU's convolutions may round by the input's alignment): every padded
    chunk's float32 probabilities gathered on the device, then one copy."""
    n, b, outs = len(images), p.batch_size, []
    for start in range(0, n, b):
        chunk = images[start:start + b]
        if len(chunk) < b:
            chunk = np.concatenate([chunk, np.zeros((b - len(chunk),) + chunk.shape[1:],
                                                    np.float32)])
        chunk = torch.from_numpy(np.ascontiguousarray(chunk))
        outs.append((p._forward_tta if tta else p._forward)(chunk))
    return torch.cat(outs)[:n].numpy()


@pytest.fixture(scope="module")
def spread(ckpt):
    """A Predictor whose probabilities spread over (0, 1): ``ckpt``'s
    weights (probabilities 0.51-0.53) with the output convolution scaled and
    shifted so that the logits of a probe request span about [-8, 8] around
    0.  The TTA mean of eight views stays within about 0.43-0.93."""
    p = Predictor(ckpt / "model.pth", batch_size=B, image_size=(HW, HW), precision="f32",
                  base_channels=4, device="cpu")
    probs = p.predict(_images(2 * B, seed=19)).astype(np.float64)
    logits = np.log(probs / (1 - probs))
    k = 16.0 / (logits.max() - logits.min())
    params = dict(p.params)
    params["out_conv.weight"] = params["out_conv.weight"] * k
    params["out_conv.bias"] = params["out_conv.bias"] * k - k * logits.mean()
    p.params = params
    return p


@pytest.mark.parametrize("tta", [False, True])
@pytest.mark.parametrize("n", [1, B - 1, B, B + 1, 5 * B // 2])
@pytest.mark.parametrize("t", [0.5, 0.3, 1 / 3, 0.0, 1.0])
def test_threshold_on_the_card_is_the_host_threshold(spread, t, n, tta):
    images = _images(n, seed=20 + n)
    probs = spread.predict(images, tta=tta)
    masks = spread.predict(images, threshold=t, tta=tta)
    assert masks.shape == (n, HW, HW, 1) and masks.dtype == np.float32
    np.testing.assert_array_equal(masks, (probs > t).astype(np.float32), strict=True)
    if t == 0.5 or (0 < t < 1 and not tta):  # both sides of the threshold occur
        assert 0 < masks.mean() < 1


@pytest.mark.parametrize("t", [0.49999999999999994, np.float64(0.49999999999999994),
                               np.float32(0.5), np.nextafter(np.float32(0.5), np.float32(0))])
def test_threshold_promotes_as_numpy(ckpt, t):
    """Zero weights give sigmoid(0) = 0.5 exactly everywhere.  Just below
    0.5 a Python float rounds to float32 0.5 (NumPy 2 compares in float32:
    no pixel is above), a float64 scalar does not (every pixel is)."""
    p = Predictor(ckpt / "model.pth", batch_size=B, image_size=(HW, HW), precision="f32",
                  base_channels=4, device="cpu")
    p.params = {k: torch.zeros_like(v) for k, v in p.params.items()}
    images = _images(B + 1, seed=30)
    probs = p.predict(images)
    assert (probs == 0.5).all()
    np.testing.assert_array_equal(p.predict(images, threshold=t),
                                  (probs > t).astype(np.float32), strict=True)


@pytest.mark.parametrize("payload", ["probs", "masks"])
def test_predict_returns_a_caller_owned_array(pair, payload):
    _, p = pair
    images = _images(2 * B + 1, seed=40)
    # these weights put every probability above 0.5: split at the median
    threshold = float(np.median(p.predict(images))) if payload == "masks" else None
    first = p.predict(images, threshold=threshold)
    kept = first.copy()
    second = p.predict(_images(2 * B + 1, seed=41), threshold=threshold)
    assert not np.array_equal(second, kept)  # other images, other results
    np.testing.assert_array_equal(first, kept, strict=True)
    for out in (first, second):
        assert out.flags.owndata and out.flags.writeable
        assert not any(np.shares_memory(out, view) for ring in p._ring.values()
                       for _, view, _ in ring)


@pytest.mark.parametrize("tta", [False, True])
@pytest.mark.parametrize("threshold", [None, 0.5])
@pytest.mark.parametrize("n", [1, B, 5 * B // 2])
def test_fetch_counts(pair, n, threshold, tta):
    _, p = pair
    before = dict(p.fetch_counts)
    p.predict(_images(n, seed=50), threshold=threshold, tta=tta)
    chunks = -(-n // B)
    payload = B * HW * HW * (1 if threshold is not None else 4)  # the pad rows too
    assert {k: v - before[k] for k, v in p.fetch_counts.items()} == {
        "chunks": chunks, "masks_on_card": chunks if threshold is not None else 0,
        "overlapped": chunks - 1, "host_bytes": chunks * payload}


@pytest.mark.parametrize("case", ["predict", "predict_tta", "tiled", "tiled_threshold"])
def test_float_payload_is_the_parent_path(pair, monkeypatch, case):
    """The float32 probabilities through the ring are bit for bit those of
    the device-side gather and one copy, so ``predict_tiled`` (which
    blends and thresholds them on the host) is unchanged."""
    _, p = pair
    if case.startswith("predict"):
        images, tta = _images(5 * B // 2, seed=60), case.endswith("tta")
        np.testing.assert_array_equal(p.predict(images, tta=tta), _parent_path(p, images, tta),
                                      strict=True)
        return
    big = _images(1, seed=61, h=90, w=70)[0]
    threshold = 0.5 if case.endswith("threshold") else None
    ours = p.predict_tiled(big, overlap=8, threshold=threshold)
    monkeypatch.setattr(p, "predict", lambda images: _parent_path(p, images))
    np.testing.assert_array_equal(ours, p.predict_tiled(big, overlap=8, threshold=threshold),
                                  strict=True)


def test_tta_matches_jax_and_is_equivariant(pair):
    jp, p = pair
    images = _images(5, seed=2)
    probs = p.predict(images, tta=True)
    assert probs.shape == (5, HW, HW, 1)
    np.testing.assert_allclose(probs, jp.predict(images, tta=True), atol=FWD_ATOL, rtol=0)
    assert np.abs(probs - p.predict(images)).max() > 1e-4  # it does average other views
    # TTA of a rotated or flipped input is the rotated or flipped TTA output
    rot = np.ascontiguousarray(np.rot90(images, 1, axes=(1, 2)))
    np.testing.assert_allclose(p.predict(rot, tta=True), np.rot90(probs, 1, axes=(1, 2)), atol=1e-5)
    flipped = np.ascontiguousarray(images[:, :, ::-1])
    np.testing.assert_allclose(p.predict(flipped, tta=True), probs[:, :, ::-1], atol=1e-5)
    # a symmetric input gives a symmetric output
    sym = np.maximum(np.maximum(images, images[:, ::-1]),
                     np.maximum(images[:, :, ::-1], images[:, ::-1, ::-1]))
    sym = np.maximum(sym, sym.transpose(0, 2, 1, 3))  # symmetric to the bit
    out = p.predict(sym, tta=True)
    np.testing.assert_allclose(out, out[:, ::-1], atol=1e-6)
    np.testing.assert_allclose(out, out.transpose(0, 2, 1, 3), atol=1e-6)


@pytest.mark.parametrize("code", range(8))
def test_d4_codes_are_the_jax_packages(code):
    from physics_informed_image_segmentation_tpu import serve as jax_serve

    x = np.random.default_rng(code).standard_normal((2, 6, 6, 3)).astype(np.float32)
    ours = _d4_apply(torch.tensor(x), code)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(jax_serve._d4_apply(jnp.asarray(x), code)))
    np.testing.assert_array_equal(_d4_invert(ours, code).numpy(), x)


def test_predict_device_equals_predict(pair):
    _, p = pair
    images = _images(8, seed=3)
    host = p.predict(images)
    dev = p.predict_device(torch.tensor(images))
    assert isinstance(dev, torch.Tensor) and dev.device.type == "cpu"
    assert dev.shape == (8, HW, HW, 1) and dev.dtype == torch.float32
    np.testing.assert_allclose(dev.numpy(), host, atol=1e-6, rtol=0)
    np.testing.assert_allclose(p.predict_device(images[..., 0]).numpy(), host, atol=1e-6, rtol=0)
    np.testing.assert_allclose(p.predict_device(torch.tensor(images), tta=True).numpy(),
                               p.predict(images, tta=True), atol=1e-6, rtol=0)


def test_validation_errors(pair):
    jp, p = pair
    with pytest.raises(ValueError, match="multiple of batch_size"):
        p.predict_device(torch.zeros((6, HW, HW, 1)))
    with pytest.raises(ValueError, match="square"):
        p.predict_device(torch.zeros((4, 16, HW, 1)), tta=True)
    with pytest.raises(ValueError, match="square"):
        p.predict(np.zeros((1, 16, HW, 1), np.float32), tta=True)
    with pytest.raises(ValueError, match="at least one image"):
        p.predict(np.zeros((0, HW, HW, 1), np.float32))
    with pytest.raises(ValueError, match=r"expected \(N, H, W"):
        p.predict_device(torch.zeros((4, HW)))
    for predictor in (p, jp):
        with pytest.raises(ValueError, match="overlap must be smaller"):
            predictor.predict_tiled(np.zeros((64, 64), np.float32), tile=32, overlap=32)


def test_predict_tiled_matches_jax(ckpt):
    jp, p = _pair(ckpt, batch_size=16)
    big = _images(1, seed=4, h=200, w=260)[0]
    ours = p.predict_tiled(big, overlap=8)
    assert ours.shape == (200, 260, 1) and np.isfinite(ours).all()
    assert (ours > 0).all() and (ours < 1).all()
    np.testing.assert_allclose(ours, jp.predict_tiled(big, overlap=8), atol=1e-5, rtol=0)
    mask = p.predict_tiled(big[..., 0], overlap=8, threshold=0.5)
    np.testing.assert_array_equal(mask, (ours > 0.5).astype(np.float32))
    # one tile covers a small image: the same as predict
    small = _images(1, seed=5)
    np.testing.assert_allclose(p.predict_tiled(small[0], tile=HW, overlap=8), p.predict(small)[0],
                               atol=1e-6, rtol=0)
    # the last tile sits flush with the border: 40 wide takes tiles at 0 and 8
    wide = _images(1, seed=6, h=HW, w=40)[0]
    np.testing.assert_allclose(p.predict_tiled(wide, overlap=8),
                               jp.predict_tiled(wide, overlap=8), atol=1e-5, rtol=0)


@pytest.mark.parametrize("precision,dtype", [("f32", torch.float32), ("bf16", torch.bfloat16)])
def test_params_hot_swap(ckpt, precision, dtype):
    p = Predictor(ckpt / "model.pth", batch_size=4, image_size=(HW, HW), precision=precision,
                  base_channels=4, device="cpu")
    images = _images(4, seed=7)
    before = p.predict(images)
    # the cast to the compute type is made when the weights are assigned
    assert all(v.dtype == dtype for v in p.model.parameters())
    assert all(v.dtype == torch.float32 for v in p.params.values())
    zeros = {k: torch.zeros_like(v) for k, v in p.params.items()}
    p.params = zeros
    assert p.params is zeros
    after = p.predict(images)
    assert not np.allclose(before, after)
    np.testing.assert_allclose(after, 0.5, atol=1e-6)  # zero weights -> sigmoid(0)


def test_bf16_matches_jax_bf16(ckpt, pair):
    jp, p = _pair(ckpt, precision="bf16")
    images = _images(4, seed=8)
    ours, ref = p.predict(images), jp.predict(images)
    assert ours.dtype == np.float32 and (ours > 0).all() and (ours < 1).all()
    np.testing.assert_allclose(ours, ref, atol=2e-3, rtol=0)
    # and bf16 is a rounding of the float32 answer, not another function
    np.testing.assert_allclose(ours, pair[1].predict(images), atol=2e-3, rtol=0)
    assert np.abs(ours - pair[1].predict(images)).max() > 0


def test_checkpoint_formats(ckpt, tmp_path):
    kw = dict(batch_size=2, image_size=(HW, HW), precision="f32", device="cpu")
    # the JAX package's .msgpack holds the weights of the .pth made from it
    from_msgpack = Predictor(ckpt / "model.msgpack", base_channels=4, **kw)
    from_pth = Predictor(ckpt / "model.pth", base_channels=4, **kw)
    for k, v in from_pth.params.items():
        torch.testing.assert_close(from_msgpack.params[k], v, rtol=0, atol=0, msg=k)
    # a file written by the port's save_params, and a model passed in
    model = UNet(base_channels=4, generator=torch.Generator().manual_seed(3))
    save_params(model, tmp_path / "own.pth")
    a = Predictor(tmp_path / "own.pth", base_channels=4, **kw)
    b = Predictor(tmp_path / "own.pth", model=UNet(base_channels=4), **kw)
    images = _images(2, seed=9)
    with torch.no_grad():
        direct = model.eval()(torch.tensor(images).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(a.predict(images), direct, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(a.predict(images), b.predict(images))
    with pytest.raises(RuntimeError):  # a checkpoint of another width
        Predictor(tmp_path / "own.pth", base_channels=8, **kw)


def test_predictor_raises_without_a_card(ckpt):
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Predictor(ckpt / "model.pth", base_channels=4)


def _write_pngs(directory, n, seed):
    from PIL import Image

    directory.mkdir()
    for i, img in enumerate(_images(n, seed=seed)):
        Image.fromarray((img[..., 0] * 255).astype(np.uint8)).save(directory / f"img_{i}.png")
    (directory / "notes.txt").write_text("not an image")
    return sorted(directory.glob("*.png"))


def test_predict_files_decodes_like_jax(pair, tmp_path):
    from physics_informed_image_segmentation_tpu.serve import (
        load_image_for_inference as jax_load_image,
    )

    jp, p = pair
    paths = _write_pngs(tmp_path / "in", 3, seed=10)
    for path in paths:
        np.testing.assert_array_equal(load_image_for_inference(path, (HW, 24)),
                                      jax_load_image(path, (HW, 24)))
    np.testing.assert_allclose(p.predict_files(paths), jp.predict_files(paths),
                               atol=FWD_ATOL, rtol=0)


def test_predict_cli_writes_the_masks_of_the_root_cli(tmp_path, monkeypatch, capsys):
    """Both CLIs at base 64 (the root ``predict.py`` has no width flag), from
    the same weights: the masks are equal except where a probability lies
    within 1e-5 of the threshold."""
    from PIL import Image

    _write_checkpoints(tmp_path, 64, seed=11)
    paths = _write_pngs(tmp_path / "in", 3, seed=12)
    common = ["--input-dir", str(tmp_path / "in"), "--image-size", str(HW), str(HW),
              "--precision", "f32", "--batch-size", "2"]
    assert predict_cli.main(["--model", str(tmp_path / "model.pth"), "--device", "cpu",
                             "--output-dir", str(tmp_path / "ours"), *common]) is None
    text = capsys.readouterr().out
    assert "Predicting 3 images with" in text and f"Wrote 3 masks to {tmp_path / 'ours'}" in text
    monkeypatch.setattr(sys, "argv", ["predict.py", "--model", str(tmp_path / "model.msgpack"),
                                      "--output-dir", str(tmp_path / "jax"), *common])
    runpy.run_path(str(REPO / "predict.py"), run_name="__main__")

    names = sorted(f.name for f in (tmp_path / "ours").iterdir())
    assert names == [f"{path.stem}_mask.png" for path in paths]
    assert names == sorted(f.name for f in (tmp_path / "jax").iterdir())
    probs = Predictor(tmp_path / "model.pth", batch_size=2, image_size=(HW, HW), precision="f32",
                      device="cpu").predict_files(paths)
    for name, prob in zip(names, probs):
        ours = np.array(Image.open(tmp_path / "ours" / name))
        ref = np.array(Image.open(tmp_path / "jax" / name))
        assert ours.dtype == np.uint8 and set(np.unique(ours)) <= {0, 255}
        np.testing.assert_array_equal(ours, (prob[..., 0] > 0.5) * np.uint8(255))
        assert (np.abs(prob[..., 0] - 0.5) <= 1e-5)[ours != ref].all()

    # an empty directory: the message of the root CLI, and no output
    (tmp_path / "empty").mkdir()
    predict_cli.main(["--model", str(tmp_path / "model.pth"), "--device", "cpu",
                      "--input-dir", str(tmp_path / "empty"),
                      "--output-dir", str(tmp_path / "none")])
    assert f"No images found in {tmp_path / 'empty'}" in capsys.readouterr().out
    assert list((tmp_path / "none").iterdir()) == []
