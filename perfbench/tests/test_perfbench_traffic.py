"""The general generator: one seed, one set of inputs; another seed, another
order of the same cameras."""

from __future__ import annotations

import numpy as np
import pytest

from perfbench import generator, spec

SEEDS = (0, 7, 2 ** 31 + 11, 2 ** 33 + 5)


@pytest.fixture(scope="module")
def path():
    return spec.load_traffic("video1080")["path"]


@pytest.mark.parametrize("seed", SEEDS)
def test_a_seed_gives_the_same_cameras(path, seed):
    a = generator.camera_path(path, seed)
    b = generator.camera_path(path, seed)
    assert len(a) == path["n_cameras"]
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert generator.check_sample(a, seed, 1) == generator.check_sample(b, seed, 1)


def test_other_seeds_send_the_same_set_in_another_order(path):
    paths = [generator.camera_path(path, s) for s in SEEDS]
    firsts = {p[0].tobytes() for p in paths}
    assert len(firsts) > 1
    sets = [sorted(c.tobytes() for c in p) for p in paths]
    assert all(s == sets[0] for s in sets)
    samples = {tuple(generator.check_sample(p, s, 1)) for p, s in zip(paths, SEEDS)}
    assert len(samples) > 1


def test_the_path_covers_every_axis_and_flip_and_the_check_every_axis(path):
    cams = generator.camera_path(path, 3)
    assert {generator.sweep_axis(c) for c in cams} == {(a, f) for a in range(3)
                                                       for f in (False, True)}
    sample = generator.check_sample(cams, 3, 1)
    assert sorted(generator.sweep_axis(cams[p])[0] for p in sample) == [0, 1, 2]
    # consecutive frames spread over the sphere: every block of 20 holds 3 axes
    for i in range(0, len(cams) - 20):
        assert len({generator.sweep_axis(c)[0] for c in cams[i:i + 20]}) == 3


def test_cameras_look_at_the_centre_from_the_radius(path):
    for cam in generator.camera_path(path, 1):
        eye, fwd = cam[:, 3], cam[:, 2]
        assert np.linalg.norm(eye - 0.5) == pytest.approx(path["radius"], rel=1e-5)
        assert np.allclose(eye + np.linalg.norm(eye - 0.5) * fwd, 0.5, atol=1e-5)
