"""PyTorch port: ``examples/quickstart_synthetic.py`` (the counterpart of
the JAX repo's ``examples/quickstart_synthetic.py``) on the CPU.

* ``main(..., device="cpu")`` at base 4, 32x32, 6/2/2 images and 1+1
  epochs writes the dataset, trains, reports finite Dice and writes one
  mask a test image (two here).
* The port's split seeds are the same in two processes with different
  ``PYTHONHASHSEED``s.  The JAX example's are not: it seeds each split with
  ``abs(hash(split)) % 1000``, and ``str`` hashes are salted per process
  (a fault of the JAX package, pinned here; ROADMAP.md queue 3).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from physics_informed_image_segmentation_tpu_torch.examples import quickstart_synthetic

REPO = Path(__file__).resolve().parent.parent
SPLITS = ("training", "validation", "testing")
JAX_EXPR = "abs(hash(split)) % 1000"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module's tests, the previous count after
    it: the suite runs several test processes side by side on one host."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_quickstart_runs_and_writes_its_masks(tmp_path):
    res = quickstart_synthetic.main(tmp_path / "run", "cpu", n_train=6, n_val=2, n_test=2,
                                    size=32, stage1_epochs=1, stage2_epochs=1, base_channels=4)
    assert all(np.isfinite(v) for v in res["dice"].values()), res["dice"]
    assert len(res["masks"]) == 2
    for path in res["masks"]:
        mask = np.asarray(Image.open(path))
        assert mask.shape == (128, 128) and set(np.unique(mask)) <= {0, 255}
    assert len(list((tmp_path / "run" / "images" / "testing").glob("*.png"))) == 2


def _seeds_in_a_process(code: str, hash_seed: str) -> list:
    env = dict(os.environ, PYTHONHASHSEED=hash_seed, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(filter(None, [str(REPO), os.environ.get("PYTHONPATH")])))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                         timeout=120, check=True)
    return json.loads(out.stdout)


@pytest.mark.parametrize("side", ["port", "jax"])
def test_split_seeds_across_processes(side):
    if side == "port":
        code = ("import json\nfrom physics_informed_image_segmentation_tpu_torch.examples "
                "import quickstart_synthetic as q\n"
                f"print(json.dumps([q.split_seed(s) for s in {SPLITS!r}]))")
    else:
        # the JAX example's expression, as its file has it
        assert JAX_EXPR in (REPO / "examples" / "quickstart_synthetic.py").read_text()
        code = f"import json\nprint(json.dumps([{JAX_EXPR} for split in {SPLITS!r}]))"
    first, second = _seeds_in_a_process(code, "1"), _seeds_in_a_process(code, "2")
    if side == "port":
        assert first == second == [quickstart_synthetic.split_seed(s) for s in SPLITS]
    else:
        assert first != second
