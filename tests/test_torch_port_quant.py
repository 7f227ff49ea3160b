"""PyTorch port: ``scripts/quant_probe.py`` (the counterpart of the JAX
repo's ``scripts/quant_probe.py``) on the CPU.

* The int8 x int8 -> int32 3x3 SAME convolution (im2col from nine shifted
  slices + ``torch._int_mm``, the weight matrix column-major) equals JAX
  ``lax.conv_general_dilated`` on int8 operands with
  ``preferred_element_type=int32`` exactly, at the JAX probe's
  (2,16,16,8) -> 16 with values in [-4, 4] and at two odd shapes with the
  full int8 range, and equals its float64 plain version there.
* The weight matrix is the HWIO kernel's (9*Cin, Cout) reshape, stored
  with K contiguous.
* A case that ``torch._int_mm`` does not take on the card (M <= 16, K or N
  not a multiple of 8) raises with its shape; there is no fallback.
* ``main`` prints the check line (error 0) and a shape line with its keys.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from physics_informed_image_segmentation_tpu_torch.scripts import quant_probe


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module's tests, the previous count after
    it: the suite runs several test processes side by side on one host."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("shape,hi", [((2, 16, 16, 8, 16), 4), ((3, 5, 7, 24, 40), 127),
                                      ((1, 9, 4, 16, 8), 127)])
def test_int8_conv_equals_jax_int8_conv(shape, hi):
    b, h, w, cin, cout = shape
    rng = np.random.default_rng(0)
    x = rng.integers(-hi, hi + 1, (b, h, w, cin), dtype=np.int8)
    k = rng.integers(-hi, hi + 1, (3, 3, cin, cout), dtype=np.int8)
    ref = np.asarray(lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(k), (1, 1), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"), preferred_element_type=jnp.int32))
    out = quant_probe.int8_conv3x3_same(torch.from_numpy(x), torch.from_numpy(k))
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), ref)
    plain = quant_probe.conv3x3_reference(torch.from_numpy(x), torch.from_numpy(k))
    np.testing.assert_array_equal(plain.numpy(), ref.astype(np.float64))


def test_weight_matrix_is_column_major():
    k = torch.arange(3 * 3 * 8 * 16, dtype=torch.int32).reshape(3, 3, 8, 16).to(torch.int8)
    w = quant_probe.weight_matrix(k)
    assert w.shape == (72, 16) and w.stride() == (1, 72)
    assert torch.equal(w, k.reshape(72, 16))


@pytest.mark.parametrize("shape", [(1, 4, 4, 8, 8), (2, 8, 8, 3, 16), (2, 8, 8, 8, 12)])
def test_shapes_int_mm_does_not_take_raise(shape):
    b, h, w, cin, cout = shape
    x = torch.zeros((b, h, w, cin), dtype=torch.int8)
    k = torch.zeros((3, 3, cin, cout), dtype=torch.int8)
    with pytest.raises(ValueError, match=f"M={b * h * w}, K={9 * cin}, N={cout}"):
        quant_probe.int8_conv3x3_same(x, k)


def test_main_prints_the_check_and_a_shape(capsys):
    assert quant_probe.main(["--device", "cpu", "--batch", "1", "--shapes", "3",
                             "--reps", "1"]) == 0
    check, line = [json.loads(s) for s in capsys.readouterr().out.splitlines()]
    assert check["max_abs_err"] == 0.0 and check["case"] == list(quant_probe.CASE)
    assert line["shape"] == [1, 16, 16, 512, 512]
    assert (line["m"], line["k"], line["n"]) == (256, 9 * 512, 512)
    assert set(line["rows"]) == {"bf16_conv", "int8_conv", "int8_gemm", "bf16_gemm"}
    assert set(line["int8_over_bf16_speed"]) == {"conv", "gemm"}
    assert all(r["ms"] > 0 and r["share_of_peak"] is None for r in line["rows"].values())
    assert line["peak_int8_ops_per_s"] is None and line["device_kind"] == "cpu"
