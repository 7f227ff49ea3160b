"""Session set-up shared by every test directory.

The JAX package's binding of the native rasteriser
(``physics_informed_image_segmentation_tpu/data/native_raster.py``) builds
``native/build/librasterize.so`` in place with g++ when a test module first
asks for it.  Under pytest-xdist every worker collects every file, so in a
fresh tree several workers would build the same path at once and one could
load another's half-written library.  The library is therefore built here,
once, in the controlling process: xdist starts its workers after this hook,
and each finds a whole library newer than its source and only loads it.
"""

import sys


def pytest_configure(config):
    # Only where ``tests/conftest.py`` has loaded JAX (on the CPU): the
    # benchmark's tests run without JAX and refuse its package in their process.
    if hasattr(config, "workerinput") or "jax" not in sys.modules:
        return
    from physics_informed_image_segmentation_tpu.data import native_raster

    native_raster.native_available()  # without g++ the tests that need it skip
