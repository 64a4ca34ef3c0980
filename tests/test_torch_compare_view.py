"""Session.compare_view, port vs the JAX package, on the analytic ball
scene of tests/test_nerf_mode.py written to disk as 8-bit RGBA PNGs with a
transforms.json (the port reads them with its own PNG decoder, the JAX
package with cv2).  The JAX session trains two bundles; the port's session
loads the same directory and takes that state.

Tolerances: the loaded images and ground truth equal (the same bytes, the
same numpy code); the rendered view at the live frame's agreement (at
least 99 % of the pixels within atol 5e-3, tests/test_torch_live.py); the
overlay equal to the JAX package's error_overlay of the port's own
prediction (rtol 1e-6); the PSNR within 0.05 dB of the JAX package's."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_nerf_mode import make_dataset, tiny_config

SCALE, OFFSET = 0.5, np.asarray([0.5, 0.5, 0.5], np.float32)


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _write_scene(root):
    from sienerf_torch.io.nerf_dataset import ngp_matrix_to_nerf
    from sienerf_torch.io.png import write_png

    ds = make_dataset()
    frames = []
    for i, (img, xf) in enumerate(zip(np.asarray(ds.images), np.asarray(ds.xforms))):
        write_png(root / f"v{i}.png", (np.clip(img, 0, 1) * 255 + 0.5).astype(np.uint8))
        m = np.eye(4, dtype=np.float32)
        m[:3] = ngp_matrix_to_nerf(xf, SCALE, OFFSET)
        frames.append({"file_path": f"v{i}", "transform_matrix": m.tolist()})
    fl = float(np.asarray(ds.focal_lengths)[0, 0])
    meta = {"fl_x": fl, "fl_y": fl, "w": ds.resolution[0], "h": ds.resolution[1],
            "aabb_scale": 1, "scale": SCALE, "offset": OFFSET.tolist(), "frames": frames}
    (root / "transforms.json").write_text(json.dumps(meta))
    (root / "net.json").write_text(json.dumps(tiny_config()))
    return root


def test_compare_view_matches_the_reference(tmp_path):
    import jax

    from sienerf_tpu.ops.tonemap import error_overlay as jax_overlay
    from sienerf_tpu.session import Session as JaxSession
    from sienerf_torch.convert import train_state_from_jax
    from sienerf_torch.session import Session

    root = _write_scene(tmp_path)
    kw = dict(train_batch_size=1 << 12, grid_size=32)
    js = JaxSession()
    js.load_file(root, network=root / "net.json", **kw)
    js.train(32)
    s = Session(device="cpu").load_file(root, network=root / "net.json", **kw)
    np.testing.assert_array_equal(s.engine.images, np.asarray(js.engine.images))
    s.state = train_state_from_jax(jax.tree.map(np.asarray, js.state), device="cpu")

    pred, gt, err, psnr = s.compare_view(1)
    jpred, jgt, jerr, jpsnr = js.compare_view(1)
    assert pred.shape == gt.shape == err.shape == (48, 48, 3)
    np.testing.assert_array_equal(gt, np.asarray(jgt))
    ok = np.abs(pred - np.asarray(jpred)).max(-1) <= 5e-3
    assert ok.mean() >= 0.99
    np.testing.assert_allclose(err, np.asarray(jax_overlay(jnp.asarray(pred), jnp.asarray(gt))),
                               rtol=1e-6, atol=1e-6)
    assert abs(psnr - jpsnr) <= 0.05 and psnr > 12.0
    small = s.compare_view(0, downscale=2)
    assert small[0].shape == (24, 24, 3) and np.isfinite(small[3])


def test_compare_view_needs_a_nerf_scene():
    from sienerf_torch.session import Session

    with pytest.raises(RuntimeError, match="NeRF scene"):
        Session(device="cpu").compare_view(0)
