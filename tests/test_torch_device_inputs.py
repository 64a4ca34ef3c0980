"""sienerf_torch/utils/device_inputs.py: small host values reach the device
with the bits `torch.as_tensor` gives them, a repeated value comes from a
bounded cache, a CPU destination takes the plain path, and the counters
count.  On the CPU the staging copy is replaced by a clone, so the routing,
the cache and the counters run here with a CUDA destination.

Tests marked `cuda` hold a spp-8 sweep frame of `Session.render` to no
host-device synchronisation (`torch.cuda.set_sync_debug_mode("error")`),
on K1's tuned path (the fox) and its general path (a seeded big.json-width
net), with the recorder off and on; frames queued back to back to the bits
of the same frames rendered alone; and the counters of a frame.

This file imports no JAX, so on the card it runs without the repo's
conftest:  python -m pytest --noconftest -p no:cacheprovider tests/test_torch_device_inputs.py
"""

from __future__ import annotations

from collections import OrderedDict
from pathlib import Path

import numpy as np
import pytest
import torch

from perfbench.generator import fibonacci_cameras
from sienerf_torch.utils import device_inputs
from sienerf_torch.utils.bbox import BoundingBox
from sienerf_torch.utils.camera import Lens, uv_to_ray
from sienerf_torch.utils.device_inputs import constant, upload

FOX = Path(__file__).resolve().parent.parent / "data" / "fox_render.snap"
CUDA = torch.device("cuda", 0)

VALUES = {
    "f32 array": np.asarray([0.25, -1.5, 3.0], np.float32),
    "f64 array": np.asarray([0.25, -1.5, 3.0], np.float64),
    "float tuple": (0.1, 0.2, 0.3),
    "int matrix": ((1, 2), (3, 4)),
    "0-d": np.float32(2.5),
    "strided": np.arange(12, dtype=np.float32).reshape(3, 4)[:, ::2],
}


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


@pytest.fixture
def staged(monkeypatch):
    """A CUDA destination served on the CPU: the staging copy is a clone,
    and the cache and counters start empty."""
    monkeypatch.setattr(device_inputs, "_from_pinned", lambda host, dev: host.clone())
    monkeypatch.setattr(device_inputs, "_cache", OrderedDict())
    for fn, name in ((upload, "pinned_copies"), (constant, "hits"), (constant, "misses")):
        monkeypatch.setattr(fn, name, 0)


def _counts():
    return upload.pinned_copies, constant.hits, constant.misses


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return (a.dtype == b.dtype and a.shape == b.shape
            and a.contiguous().reshape(-1).view(torch.uint8).tolist()
            == b.contiguous().reshape(-1).view(torch.uint8).tolist())


# --- on the CPU ----------------------------------------------------------------


@pytest.mark.parametrize("fn", [upload, constant], ids=["upload", "constant"])
@pytest.mark.parametrize("name", list(VALUES))
def test_a_cuda_destination_gets_the_bits_of_as_tensor(staged, fn, name):
    value = VALUES[name]
    got = fn(value, CUDA)
    assert _same_bits(got, torch.as_tensor(value))
    assert _same_bits(fn(value, CUDA), got)  # a second call too (a cache hit for constant)


@pytest.mark.parametrize("other,hit", [
    (np.asarray([0.25, -1.5, 3.0], np.float32), True),  # equal bytes, another array
    ((0.25, -1.5, 3.0), True),  # a tuple reads as the same float32 bytes
    (np.asarray([0.25, -1.5, 2.0], np.float32), False),  # value
    (np.asarray([0.0, 0.0, 0.0], np.float32), False),
    (np.asarray([0.25, -1.5, 3.0], np.float64), False),  # dtype
    (np.asarray([[0.25, -1.5, 3.0]], np.float32), False),  # shape
], ids=["equal", "tuple", "value", "zeros", "dtype", "shape"])
def test_equal_bytes_hit_the_cache_and_any_difference_misses(staged, other, hit):
    first = constant(np.asarray([0.25, -1.5, 3.0], np.float32), CUDA)
    again = constant(other, CUDA)
    assert (again is first) == hit
    assert _counts() == (2 - hit, int(hit), 2 - hit)


def test_another_device_and_the_sign_of_zero_miss(staged):
    z = np.zeros(3, np.float32)
    a = constant(z, CUDA)
    assert constant(z, torch.device("cuda", 1)) is not a
    assert constant(-z, CUDA) is not a  # -0.0 has other bytes
    assert constant(z, CUDA) is a
    assert _counts() == (3, 1, 3)


def test_the_cache_keeps_the_most_recently_used_within_its_bound(staged):
    size = device_inputs.CACHE_SIZE
    keep = constant(np.float32(-1.0), CUDA)
    for i in range(3 * size):
        constant(np.float32(i), CUDA)
        assert constant(np.float32(-1.0), CUDA) is keep  # touched each time: never evicted
        assert len(device_inputs._cache) <= size
    assert len(device_inputs._cache) == size
    assert constant(np.float32(0.0), CUDA) is not None and constant.misses == 3 * size + 2


def test_a_cached_tensor_written_in_place_is_copied_again(staged):
    v = np.asarray([1.0, 2.0], np.float32)
    t = constant(v, CUDA)
    t.add_(1.0)  # a caller breaking the contract
    u = constant(v, CUDA)
    assert u is not t and u.tolist() == [1.0, 2.0]
    assert _counts() == (2, 0, 2)


@pytest.mark.parametrize("fn", [upload, constant], ids=["upload", "constant"])
@pytest.mark.parametrize("device", ["cpu", torch.device("cpu")], ids=["str", "device"])
def test_a_cpu_destination_pins_nothing_and_is_as_tensor(monkeypatch, fn, device):
    def refuse(*_):
        raise AssertionError("a CPU destination staged a copy")

    monkeypatch.setattr(torch.Tensor, "pin_memory", refuse)
    monkeypatch.setattr(device_inputs, "_from_pinned", refuse)
    before = _counts()
    a = np.asarray([0.5, 1.5, -2.0], np.float32)
    got = fn(a, device)
    assert _same_bits(got, torch.as_tensor(a, device=device))
    assert got.data_ptr() == a.ctypes.data  # shares the array's memory, as as_tensor does
    assert _same_bits(fn((0.1, 0.2), device), torch.as_tensor((0.1, 0.2), device=device))
    assert _counts() == before


def test_the_counters_count_as_documented(staged):
    cam = np.eye(3, 4, dtype=np.float32)
    upload(cam, CUDA)
    upload(cam, CUDA)  # a value that changes is copied every time
    assert _counts() == (2, 0, 0)
    box = np.ones(3, np.float32)
    constant(box, CUDA)  # a miss is one pinned copy
    assert _counts() == (3, 0, 1)
    constant(box, CUDA)
    constant(box.copy(), CUDA)
    assert _counts() == (3, 2, 1)
    upload(cam, "cpu")
    constant(box, "cpu")
    assert _counts() == (3, 2, 1)


def _old_uv_to_ray(uv, resolution, focal, camera_matrix, screen_center):
    """uv_to_ray's pinhole branch as it read before the helper."""
    cam = torch.as_tensor(np.asarray(camera_matrix, np.float32), device=uv.device)
    res = np.asarray(resolution, np.float32)
    fl = np.asarray(focal, np.float32)
    sc = np.asarray(screen_center, np.float32)
    x = (uv[..., 0] - float(sc[0])) * float(res[0]) / float(fl[0])
    y = (uv[..., 1] - float(sc[1])) * float(res[1]) / float(fl[1])
    d = torch.stack([x, y, torch.ones_like(x)], dim=-1)
    rot = cam[:3, :3]
    direction = torch.stack([rot[r, 0] * d[..., 0] + rot[r, 1] * d[..., 1] + rot[r, 2] * d[..., 2]
                             for r in range(3)], dim=-1)
    return cam[:3, 3].expand(direction.shape), direction


def _old_ray_intersect(lo, hi, origin, direction, eps=1e-12):
    """BoundingBox.ray_intersect as it read before the helper."""
    lo = torch.as_tensor(lo, device=origin.device)
    hi = torch.as_tensor(hi, device=origin.device)
    tiny = torch.where(direction < 0, -eps, eps).to(direction.dtype)
    inv_d = 1.0 / torch.where(direction.abs() < eps, tiny, direction)
    t0 = (lo - origin) * inv_d
    t1 = (hi - origin) * inv_d
    return torch.minimum(t0, t1).amax(dim=-1), torch.maximum(t0, t1).amin(dim=-1)


@pytest.mark.parametrize("kind", ["array", "tuple"])
def test_uv_to_ray_and_ray_intersect_keep_their_bits(kind):
    cam = fibonacci_cameras(120, 1.8)[7]
    lo, hi = np.asarray([-1.5, -1.5, -1.5], np.float32), np.asarray([2.5, 2.5, 2.5], np.float32)
    if kind == "tuple":
        cam = tuple(tuple(float(x) for x in row) for row in cam)
        lo, hi = tuple(float(x) for x in lo), tuple(float(x) for x in hi)
    g = torch.Generator().manual_seed(3)
    uv = torch.rand((64, 2), generator=g)
    o, d = uv_to_ray(uv, (32, 18), (30.0, 30.0), cam, (0.5, 0.5), Lens())
    o_old, d_old = _old_uv_to_ray(uv, (32, 18), (30.0, 30.0), cam, (0.5, 0.5))
    assert _same_bits(o, o_old) and _same_bits(d, d_old)
    t = BoundingBox(lo, hi).ray_intersect(o, d)
    t_old = _old_ray_intersect(lo, hi, o, d)
    assert all(_same_bits(a, b) for a, b in zip(t, t_old))


# --- on the card -------------------------------------------------------------

W, H, FOCAL = 320, 180, (275.0, 275.0)


def _cam(k: int) -> np.ndarray:
    return fibonacci_cameras(120, 1.8)[k]


@pytest.fixture(scope="module")
def card_sessions():
    """The fox (K1's tuned path) and a seeded big.json-width net (K1's
    general path), baked on the card, each with one warm-up frame."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from perfbench import spec
    from perfbench.kinds.video import load_session
    from sienerf_torch.session import Session

    torch.backends.cuda.matmul.allow_tf32 = False
    fox = Session(device="cuda")
    fox.load_snapshot(FOX)
    fox.bake(resolution=256)
    big = load_session(spec.load_config(spec.load_benchmark(), "big"), 2147483659, "cuda")
    big.bake(resolution=128)
    for s in (fox, big):
        s.render(W, H, _cam(0), focal=FOCAL, spp=8, renderer="sweep").cpu()
    return {"fox": fox, "big": big}


@pytest.mark.cuda
@pytest.mark.parametrize("recorder", ["off", "on"])
@pytest.mark.parametrize("net", ["fox", "big"])
def test_a_sweep_frame_never_synchronises(card_sessions, net, recorder, monkeypatch):
    # The recorder is turned on as a profiler session would turn it on, with
    # no session: profiler sessions started here left the one-kernel trace
    # of tests/test_torch_tracing.py's clock test without its kernel when
    # both files ran in one process.
    from sienerf_torch import tracing

    monkeypatch.setattr(tracing, "profiling", lambda: recorder == "on")
    s = card_sessions[net]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        rgba = s.render(W, H, _cam(5), focal=FOCAL, spp=8, renderer="sweep")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    if recorder == "on":
        assert len(tracing.RECORDER.read().named("pass")) == 8
    assert rgba.shape == (H, W, 4) and bool(torch.isfinite(rgba).all())


@pytest.mark.cuda
def test_frames_queued_back_to_back_equal_frames_rendered_alone(card_sessions):
    s = card_sessions["fox"]
    cams = [_cam(k) for k in (11, 23, 47, 64, 90, 113)]
    alone = []
    for cam in cams:
        torch.cuda.synchronize()
        alone.append(s.render(W, H, cam, focal=FOCAL, spp=8, renderer="sweep").cpu())
    torch.cuda.synchronize()
    torch.cuda._sleep(400_000_000)  # hold the device, so every frame's copies queue behind it
    queued = [s.render(W, H, cam, focal=FOCAL, spp=8, renderer="sweep") for cam in cams]
    queued = [f.cpu() for f in queued]
    for k, (a, b) in enumerate(zip(alone, queued)):
        assert torch.equal(a, b), f"frame {k} differs when queued"
    assert not torch.equal(alone[0], alone[1])


@pytest.mark.cuda
def test_the_counters_of_a_frame(card_sessions, monkeypatch):
    s = card_sessions["fox"]
    monkeypatch.setattr(device_inputs, "_cache", OrderedDict())

    def frame_counts(cam):
        before = _counts()
        s.render(W, H, cam, focal=FOCAL, spp=8, renderer="sweep").cpu()
        return tuple(b - a for a, b in zip(before, _counts()))

    # a pass: the camera uploaded; the box's corners and the background from the cache
    assert frame_counts(_cam(3)) == (8 + 3, 3 * 8 - 3, 3)
    assert frame_counts(_cam(4)) == (8, 3 * 8, 0)
