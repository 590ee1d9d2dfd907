"""Golden regression tests: 128² renders of every example config and pixel
gradients of named scene parameters, pinned against tests/goldens/*.npz.

BASELINE.json's acceptance metric is "image + pixel-gradient allclose";
since the reference cannot run here, the goldens pin *this* framework's
verified output (visually inspected) so regressions are caught.  The
statistical comparison against the reference's published renders
(/root/reference/media/*.png) lives in tests/test_reference_media.py.
Regenerate intentionally with:
    JAX_PLATFORMS=cpu python tools/make_goldens.py
"""
import importlib.util
import os

import numpy as np
import pytest

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_tool():
    spec = importlib.util.spec_from_file_location(
        "make_goldens", os.path.join(REPO, "tools", "make_goldens.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def goldens():
    path = os.path.join(GOLDEN_DIR, "images.npz")
    if not os.path.exists(path):
        pytest.skip("no golden images (run tools/make_goldens.py)")
    return np.load(path)


@pytest.mark.parametrize("name", ["simple_scene", "global_illumination",
                                  "light_shafts", "obj_mesh", "bvh_test",
                                  "ball_game"])
def test_image_golden(goldens, name):
    if name not in goldens.files:
        pytest.skip(f"no golden for {name} yet (run tools/make_goldens.py)")
    ref = goldens[name]
    # one render per scene, so one scene's failure cannot hide another's
    img = _load_tool().render_config(name)
    assert img.shape == ref.shape
    # CPU renders are deterministic; the tolerance absorbs XLA version /
    # fusion-order drift only.
    np.testing.assert_allclose(img, ref, atol=5e-4,
                               err_msg=f"golden drift in {name}")


def test_gradient_goldens():
    path = os.path.join(GOLDEN_DIR, "gradients.npz")
    if not os.path.exists(path):
        pytest.skip("no golden gradients (run tools/make_goldens.py)")
    ref = np.load(path)
    got = _load_tool().gradient_goldens()
    for name in ref.files:
        np.testing.assert_allclose(
            got[name], ref[name], rtol=1e-3,
            err_msg=f"pixel-gradient drift in d(loss)/d({name})")
