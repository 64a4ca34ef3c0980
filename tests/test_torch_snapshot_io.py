"""Training snapshots, port vs reference: the msgpack encoder, the native
snapshot container both ways, and the Session's save / load of a training
state.

Tolerances: none.  The encoder's bytes equal the JAX package's encoder's
(and msgpack's own, for a snapshot payload); a snapshot written by either
package loads in the other to the same arrays, bit for bit and dtype for
dtype, except the occupancy density, which the format stores as fp16 (so
it comes back as the fp16 rounding of what was saved); a Session's save
-> load round trip gives the same state and renders the same frame."""

import functools
import json

import jax
import msgpack
import numpy as np
import pytest
import torch

from test_nerf_mode import make_dataset
from test_torch_train import small_config


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


PACK_CASES = [None, True, False, 0, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32,
              2 ** 63, -1, -32, -33, -128, -129, -2 ** 15 - 1, -2 ** 31 - 1, -2 ** 63, 1.5,
              -0.0, "é" * 15, "a" * 32, "b" * 300, "c" * 70000, b"", b"x" * 256,
              b"y" * 70000, list(range(15)), list(range(16)), list(range(70000)),
              {str(i): i for i in range(15)}, {str(i): [i, 2.5] for i in range(16)},
              {1: "int key"}, np.int32(-7), np.float32(2.5), np.arange(7, dtype=np.float16)]


@pytest.mark.parametrize("i", range(len(PACK_CASES)))
def test_pack_is_bit_equal_to_the_reference_encoder(i):
    from sienerf_tpu.io import msgpack_lite as jm
    from sienerf_torch.io import msgpack_lite as tm

    obj = PACK_CASES[i]
    assert tm.pack(obj) == jm.pack(obj)
    back = tm.unpack(tm.pack(obj))
    assert back == jm.unpack(jm.pack(obj))


@functools.lru_cache(maxsize=1)
def jax_state():
    """A JAX engine's training state with seeded contents in every leaf
    (params, Adam moments, EMA, occupancy, error map)."""
    from sienerf_tpu.engines.nerf import NerfEngine

    eng = NerfEngine.create(small_config(), make_dataset(), grid_size=16)
    st = jax.tree.map(np.asarray, eng.init(0))
    rng = np.random.default_rng(0)

    def fill(x):
        if x.dtype == np.float32 and x.ndim:
            return rng.standard_normal(x.shape).astype(np.float32)
        return x

    st["opt"] = {k: (jax.tree.map(fill, v) if k != "step" else np.int32(37))
                 for k, v in st["opt"].items()}
    st["params"] = jax.tree.map(fill, st["params"])
    st["occ"] = {"density": rng.random(st["occ"]["density"].shape).astype(np.float32) * 0.02,
                 "bitfield": rng.random(st["occ"]["bitfield"].shape) < 0.3,
                 "mean_density": np.float32(0.0123), "n_updates": np.int32(3)}
    st["step"] = np.int32(37)
    st["emap"] = {"error": rng.random(st["emap"]["error"].shape).astype(np.float32),
                  "decay": np.float32(0.9995)}
    return st


def _assert_state_equal(got: dict, want: dict, path=""):
    """Port states: tensors equal in value and dtype, Python scalars equal;
    the occupancy density compared after its fp16 rounding."""
    if isinstance(want, dict):
        assert got.keys() == want.keys(), path
        for k in want:
            _assert_state_equal(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            _assert_state_equal(a, b, f"{path}[{i}]")
    elif isinstance(want, torch.Tensor):
        if path == "/occ/density":
            want = want.half().float()
        assert got.dtype == want.dtype and torch.equal(got, want), path
    else:
        assert type(got) is type(want) and got == want, path


def test_reference_snapshot_loads_to_the_converted_state(tmp_path):
    from sienerf_tpu.io.snapshot import save_snapshot
    from sienerf_torch.convert import train_state_from_jax
    from sienerf_torch.io.snapshot import load_snapshot

    st = jax_state()
    save_snapshot(tmp_path / "j.snap", st, small_config(), {"training_step": 37})
    payload = load_snapshot(tmp_path / "j.snap")
    assert payload["config"] == small_config() and payload["meta"] == {"training_step": 37}
    _assert_state_equal(train_state_from_jax(payload["state"], "cpu"),
                        train_state_from_jax(st, "cpu"))


def test_port_snapshot_loads_in_the_reference(tmp_path):
    from sienerf_tpu.io.snapshot import load_snapshot
    from sienerf_torch.convert import train_state_from_jax, train_state_to_jax
    from sienerf_torch.io.snapshot import save_snapshot

    st = jax_state()
    save_snapshot(tmp_path / "t.snap", train_state_to_jax(train_state_from_jax(st, "cpu")),
                  small_config(), {"training_step": 37})
    got = load_snapshot(tmp_path / "t.snap")["state"]
    flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
    flat_w = dict(jax.tree_util.tree_flatten_with_path(st)[0])
    assert len(flat_g) == len(flat_w)
    for k, a in flat_g:
        b = np.asarray(flat_w[k])
        if jax.tree_util.keystr(k) == "['occ']['density']":
            b = b.astype(np.float16).astype(np.float32)
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), k


def test_port_round_trip_and_bytes(tmp_path):
    import zlib

    from sienerf_torch.convert import train_state_from_jax, train_state_to_jax
    from sienerf_torch.io.snapshot import _pack_tree, load_snapshot, save_snapshot

    state = train_state_from_jax(jax_state(), "cpu")
    save_snapshot(tmp_path / "t.snap", train_state_to_jax(state), small_config(), {"a": 1})
    back = train_state_from_jax(load_snapshot(tmp_path / "t.snap")["state"], "cpu")
    _assert_state_equal(back, state)
    # the same bytes as msgpack's own encoder writes for the payload
    raw = zlib.decompress((tmp_path / "t.snap").read_bytes())
    np_state = train_state_to_jax(state)
    np_state["occ"]["density"] = np_state["occ"]["density"].astype(np.float16)
    payload = {"version": 1, "state": _pack_tree(np_state), "config": small_config(),
               "meta": {"a": 1}}
    assert raw == msgpack.packb(payload, use_bin_type=True)


def _trained_session(tmp_path, seed=5, steps=16):
    from test_torch_dataset import _small_network, _write_scene

    from sienerf_torch.session import Session

    scene = tmp_path / "scene"
    scene.mkdir(exist_ok=True)
    _write_scene(scene, np.random.default_rng(3))
    sess = Session(seed=seed, device="cpu")
    sess.load_file(scene, network=_small_network(tmp_path), grid_size=16,
                   train_batch_size=1 << 10, train_k=16)
    if steps:
        sess.train(steps)
    return sess


def test_session_save_and_load_a_training_snapshot(tmp_path):
    from sienerf_tpu.io.snapshot import load_snapshot as jload
    from sienerf_torch.session import Session

    sess = _trained_session(tmp_path)
    sess.engine._phase = "fast"
    sess.save_snapshot(tmp_path / "s.snap")
    meta = jload(tmp_path / "s.snap")["meta"]
    assert meta["training_step"] == 16 and meta["train_phase"] == "fast"
    assert meta["mean_samples"] == sess.engine._mean_samples
    assert meta["aabb_scale"] == 1.0 and meta["mode"] == "nerf"

    # into a fresh session: the engine comes from the snapshot's config
    fresh = Session(device="cpu")
    fresh.load_snapshot(tmp_path / "s.snap")
    _assert_state_equal(fresh.state, sess.state)
    assert fresh.training_step == 16 and fresh.engine._mean_samples == sess.engine._mean_samples
    assert fresh.engine.net == sess.engine.net
    cam = sess.engine.xforms[0]
    a = sess.render(12, 8, cam, (10.0, 10.0))
    b = fresh.render(12, 8, cam, (10.0, 10.0))
    assert torch.equal(a, b)
    # onto the loaded scene's engine, which then trains on
    sess2 = _trained_session(tmp_path, seed=9, steps=0)
    sess2.load_snapshot(tmp_path / "s.snap")
    _assert_state_equal(sess2.state, sess.state)
    assert np.isfinite(sess2.train(16)) and sess2.training_step == 32


def test_reload_network_from_file_starts_afresh(tmp_path):
    from test_torch_dataset import _small_network

    sess = _trained_session(tmp_path, steps=0)
    sess.state["params"]["grid"] += 1.0  # as if trained
    trained = sess.state["params"]["grid"].clone()
    cfg = small_config()
    cfg["encoding"] = dict(cfg["encoding"], n_levels=2)
    other = tmp_path / "other.json"
    other.write_text(json.dumps(cfg))
    sess.reload_network_from_file(other)
    assert sess.training_step == 0 and sess.state["step"] == 0
    assert sess.network_config == cfg and sess.engine.net.grid.n_levels == 2
    # the same config again: a fresh state, not the trained one
    sess.reload_network_from_file(_small_network(tmp_path))
    assert sess.network_config == small_config()
    assert not torch.equal(sess.state["params"]["grid"], trained)


def test_snapshot_kinds_are_told_apart(tmp_path):
    from sienerf_tpu.io.ingp import save_ingp
    from sienerf_torch.session import _is_reference_snapshot

    from test_torch_snapshot import FOX

    save_ingp(tmp_path / "a.ingp", {"snapshot": {"version": 1}})
    (tmp_path / "junk.snap").write_bytes(b"not a snapshot")
    assert _is_reference_snapshot(tmp_path / "a.ingp")
    assert not _is_reference_snapshot(FOX)
    assert not _is_reference_snapshot(tmp_path / "junk.snap")


def test_snapshots_a_scene_cannot_take_raise(tmp_path):
    """A render-only snapshot carries no network config or aabb_scale; a
    training snapshot without meta["aabb_scale"] whose occupancy grid has
    several cascades cannot say its scale either."""
    from sienerf_tpu.io.snapshot import save_snapshot
    from sienerf_torch.session import Session

    from test_torch_snapshot import FOX

    st = dict(jax_state())
    st["occ"] = dict(st["occ"], density=np.zeros((3, 16, 16, 16), np.float32),
                     bitfield=np.zeros((3, 16, 16, 16), bool))
    save_snapshot(tmp_path / "multi.snap", st, small_config(), {})
    for snap, match in ((FOX, "render-only"), (tmp_path / "multi.snap", "aabb_scale")):
        scene = tmp_path / "s.geometry.json"
        scene.write_text(json.dumps({"geometry": [{"type": "Nerf", "path": str(snap)}]}))
        with pytest.raises(ValueError, match=match):
            Session(device="cpu").load_file(scene)
