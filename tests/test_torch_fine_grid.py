"""The fine render grid, port vs the JAX package, on the tiny seeded field
of tests/test_torch_live.py (a ball of occupied 32^3 cells with blocks cut
out):

- bake_render_grid / bake_fine_bitfield at factor 2 against the JAX
  package's: before the dilation, equal except voxels whose density lies
  within the network's agreement tolerance of the threshold (the two
  packages' bf16 MLPs round apart there: rtol 2e-2 on the density, the
  live renderer's nerf_apply tolerance), each such voxel shown and
  counted; after the dilation, on the same densities, equal;
- a live frame through the fine grid against the JAX package's frame on
  the same fine grid: at least 99 % of the pixels within atol 5e-3, as
  tests/test_torch_live.py holds frames; and the fine grid's frame takes
  fewer samples than the coarse grid's (render mode `cost`);
- both again on a field of three cascades (aabb 4, as the fox) at the
  factor 4 that frames use, from a camera in the outermost cascade: the
  per-cascade voxel centres, and the march's fine probes and fine skips
  above cascade 0, which take fewer samples there too."""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_nerf_mode import make_dataset, tiny_config
from test_torch_live import FOCAL, H, W, _cam, _continuous_cell_grid, tiny

FACTOR = 2
NET_RTOL = 2e-2


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _mean_density(jeng, jp, bf):
    """A threshold inside the field's range: the median activated density
    at the occupied cells' centres, as optical thickness."""
    from sienerf_tpu.common import MIN_CONE_STEPSIZE
    from sienerf_tpu.models.nerf_network import apply_density_activation, density_raw

    g = bf.shape[1]
    c = (np.argwhere(bf[0]) + 0.5) / g
    d = apply_density_activation(density_raw(jeng.net, jp, jnp.asarray(c, jnp.float32)),
                                 jeng.net.density_activation)
    return float(np.median(np.asarray(d))) * MIN_CONE_STEPSIZE


def _centres(bf):
    """Every fine voxel's centre, in row-major order."""
    g = bf.shape[1] * FACTOR
    idx = np.argwhere(np.ones((g, g, g), bool))
    return idx, ((idx + 0.5) / g).astype(np.float32)


def test_fine_bitfield_matches_the_reference():
    from sienerf_tpu.common import MIN_CONE_STEPSIZE
    from sienerf_tpu.models.nerf_network import apply_density_activation, density_raw
    from sienerf_tpu.ops.occupancy import bake_fine_bitfield as jbake
    from sienerf_torch.models import nerf_network as tn
    from sienerf_torch.ops.occupancy import bake_fine_bitfield

    jeng, jp, teng, tp, bf = tiny()
    md = _mean_density(jeng, jp, bf)
    thresh = min(md, 0.01) / MIN_CONE_STEPSIZE

    def jdens(p, pos):
        return apply_density_activation(density_raw(jeng.net, p, pos), jeng.net.density_activation)

    def tdens(pos):
        return tn.apply_density_activation(tn.density_raw(teng.net, tp, pos),
                                           teng.net.density_activation)

    want = jbake(jdens, jp, bf, md, factor=FACTOR, dilate=False)
    got = bake_fine_bitfield(tdens, torch.from_numpy(bf), md, factor=FACTOR, dilate=False)
    assert got.dtype == torch.bool and got.shape == want.shape == (1, 64, 64, 64)
    got = got.numpy()
    up = bf[0].repeat(FACTOR, 0).repeat(FACTOR, 1).repeat(FACTOR, 2)
    assert 0 < want.sum() < up.sum()  # keeps some fine voxels of occupied cells, not all
    diff = np.argwhere(got != want)
    pos = ((diff[:, 1:] + 0.5) / (bf.shape[1] * FACTOR)).astype(np.float32)
    dj = np.asarray(jdens(jp, jnp.asarray(pos))) if len(diff) else np.zeros(0)
    dt = tdens(torch.from_numpy(pos)).numpy() if len(diff) else np.zeros(0)
    for v, a, b in zip(diff, dt, dj):
        print(f"voxel {tuple(v)}: port density {a:.6g}, reference {b:.6g}, threshold "
              f"{thresh:.6g}")
    print(f"{len(diff)} of {got.size} voxels differ, all within rtol {NET_RTOL} of the "
          f"threshold")
    assert len(diff) <= 0.002 * got.size
    assert (np.abs(dt - thresh) <= NET_RTOL * thresh).all()
    assert (np.abs(dj - thresh) <= NET_RTOL * thresh).all()

    # the dilation on the same densities: equal
    jfull = np.array(jdens(jp, jnp.asarray(_centres(bf)[1])))

    def same_density(pos):
        g = bf.shape[1] * FACTOR
        ijk = torch.floor(pos * g).long()
        flat = (ijk[:, 0] * g + ijk[:, 1]) * g + ijk[:, 2]
        return torch.from_numpy(jfull)[flat]

    wantd = jbake(jdens, jp, bf, md, factor=FACTOR)
    gotd = bake_fine_bitfield(same_density, torch.from_numpy(bf), md, factor=FACTOR)
    np.testing.assert_array_equal(gotd.numpy(), wantd)
    assert wantd.sum() > want.sum()  # the dilation added voxels


def test_engine_bake_render_grid():
    jeng, jp, teng, tp, bf = tiny()
    md = _mean_density(jeng, jp, bf)
    occ = {"bitfield": torch.from_numpy(bf), "mean_density": torch.tensor(md)}
    got = teng.bake_render_grid(tp, occ, factor=FACTOR)
    want = np.asarray(jeng.bake_render_grid(jp, {"bitfield": jnp.asarray(bf),
                                                  "mean_density": jnp.float32(md)},
                                            factor=FACTOR))
    assert got.shape == want.shape and got.dtype == torch.bool
    # dilated grids: a voxel that flipped near the threshold may add its
    # neighbours; the rest is equal
    assert (got.numpy() != want).mean() <= 0.01


def test_fine_grid_frame_matches_the_reference():
    jeng, jp, teng, tp, bf = tiny()
    md = _mean_density(jeng, jp, bf)
    fine = np.array(jeng.bake_render_grid(jp, {"bitfield": jnp.asarray(bf),
                                                 "mean_density": jnp.float32(md)},
                                           factor=FACTOR))
    want, _ = jeng.render_frame(jp, jnp.asarray(bf), W, H, _cam(), FOCAL,
                                fine_bitfield=jnp.asarray(fine))
    got, _ = teng.render_frame(tp, torch.from_numpy(bf), W, H, _cam(), FOCAL,
                               fine_bitfield=torch.from_numpy(fine))
    ok = np.abs(got.numpy() - np.asarray(want)).max(-1) <= 5e-3
    assert ok.mean() >= 0.99
    assert 0.05 < float(got[..., 3].mean())
    cost = {}
    for name, fb in (("coarse", None), ("fine", torch.from_numpy(fine))):
        c, _ = teng.render_frame(tp, torch.from_numpy(bf), W, H, _cam(), FOCAL,
                                 fine_bitfield=fb, render_mode="cost")
        cost[name] = float(c[..., 0].sum())
    assert cost["fine"] < cost["coarse"]


CASC_G, CASC_FACTOR, CASC_EYE = 16, 4, (2.0, 1.1, -0.9)


@functools.lru_cache(maxsize=1)
def three_cascades():
    """(JAX engine, JAX params, port engine, port params, bitfield): tiny()'s
    field at aabb 4 (three cascades) on a 16^3 grid.  Each cascade holds a
    ball of radius 0.35 of its own extent with random 2^3 blocks cut out."""
    import jax

    from sienerf_tpu.engines.nerf import NerfEngine as JaxEngine
    from sienerf_torch.convert import params_from_jax
    from sienerf_torch.engines.nerf import NerfEngine
    from sienerf_torch.io.nerf_dataset import NerfDataset

    G = CASC_G
    ds = dataclasses.replace(make_dataset(), aabb_scale=4.0)
    jeng = JaxEngine.create(tiny_config(), ds, train_batch_size=1 << 12, grid_size=G,
                            train_k=48)
    assert jeng.march.n_cascades == 3
    p = jax.tree.map(np.asarray, jeng.init(0)["params"])
    rng = np.random.default_rng(1)
    p["grid"] = _continuous_cell_grid(jeng.net.grid, rng)
    p["density_mlp"][-1] = p["density_mlp"][-1] * 12.0
    ax = (np.arange(G) + 0.5) / G
    x, y, z = np.meshgrid(ax, ax, ax, indexing="ij")
    ball = (x - 0.5) ** 2 + (y - 0.5) ** 2 + (z - 0.5) ** 2 < 0.35 ** 2
    bitfield = np.stack([ball & (rng.random((G // 2,) * 3) < 0.6).repeat(2, 0).repeat(2, 1)
                         .repeat(2, 2) for _ in range(3)])
    tds = NerfDataset(images=np.zeros((1, 8, 8, 4), np.float32),
                      xforms=np.asarray(ds.xforms),
                      focal_lengths=np.asarray(ds.focal_lengths),
                      principal_points=np.asarray(ds.principal_points),
                      resolution=ds.resolution, aabb_scale=ds.aabb_scale)
    teng = NerfEngine.create(tiny_config(), tds, grid_size=G, train_k=48, device="cpu")
    return (jeng, jax.tree.map(jnp.asarray, p), teng, params_from_jax(p, device="cpu"),
            bitfield)


def test_fine_bitfield_matches_the_reference_on_three_cascades():
    """Mean density at the cap NERF_MIN_OPTICAL_THICKNESS, so that every
    cascade drops fine voxels; undilated and dilated grids as above."""
    from sienerf_tpu.common import MIN_CONE_STEPSIZE, NERF_MIN_OPTICAL_THICKNESS
    from sienerf_tpu.models.nerf_network import apply_density_activation, density_raw
    from sienerf_tpu.ops.occupancy import bake_fine_bitfield as jbake
    from sienerf_torch.models import nerf_network as tn
    from sienerf_torch.ops.occupancy import bake_fine_bitfield

    jeng, jp, teng, tp, bf = three_cascades()
    md, f = NERF_MIN_OPTICAL_THICKNESS, CASC_FACTOR
    thresh = md / MIN_CONE_STEPSIZE

    def jdens(p, pos):
        return apply_density_activation(density_raw(jeng.net, p, pos), jeng.net.density_activation)

    def tdens(pos):
        return tn.apply_density_activation(tn.density_raw(teng.net, tp, pos),
                                           teng.net.density_activation)

    want = jbake(jdens, jp, bf, md, factor=f, dilate=False)
    got = bake_fine_bitfield(tdens, torch.from_numpy(bf), md, factor=f, dilate=False).numpy()
    assert got.shape == want.shape == (3, 64, 64, 64)
    up = bf.repeat(f, 1).repeat(f, 2).repeat(f, 3)
    for c in range(3):  # every cascade keeps some fine voxels of its cells, not all
        assert 0 < want[c].sum() < up[c].sum()
    diff = np.argwhere(got != want)
    gf = CASC_G * f
    pos = ((diff[:, 1:] + 0.5) / gf - 0.5) * 2.0 ** diff[:, :1] + 0.5
    pos = pos.astype(np.float32)
    dj = np.asarray(jdens(jp, jnp.asarray(pos))) if len(diff) else np.zeros(0)
    dt = tdens(torch.from_numpy(pos)).numpy() if len(diff) else np.zeros(0)
    for v, a, b in zip(diff, dt, dj):
        print(f"voxel {tuple(v)}: port density {a:.6g}, reference {b:.6g}, threshold "
              f"{thresh:.6g}")
    print(f"{len(diff)} of {got.size} voxels differ, all within rtol {NET_RTOL} of the "
          f"threshold")
    assert len(diff) <= 0.002 * got.size
    assert (np.abs(dt - thresh) <= NET_RTOL * thresh).all()
    assert (np.abs(dj - thresh) <= NET_RTOL * thresh).all()

    # the dilation on the reference's densities: equal
    def same_density(pos):
        return torch.from_numpy(np.array(jdens(jp, jnp.asarray(pos.numpy()))))

    wantd = jbake(jdens, jp, bf, md, factor=f)
    gotd = bake_fine_bitfield(same_density, torch.from_numpy(bf), md, factor=f)
    np.testing.assert_array_equal(gotd.numpy(), wantd)
    assert wantd.sum() > want.sum()


def test_fine_grid_frame_matches_the_reference_on_three_cascades():
    """The frame through the factor-4 grid of three cascades against the
    JAX package's on the same grid, as above; and the fine grid of
    cascades 1 and 2 takes samples away from a frame whose cascade 0 alone
    is fine, so the probes above cascade 0 are used."""
    from sienerf_tpu.common import NERF_MIN_OPTICAL_THICKNESS
    from sienerf_torch.utils.camera import look_at_matrix

    jeng, jp, teng, tp, bf = three_cascades()
    md, f = NERF_MIN_OPTICAL_THICKNESS, CASC_FACTOR
    fine = np.array(jeng.bake_render_grid(jp, {"bitfield": jnp.asarray(bf),
                                                 "mean_density": jnp.float32(md)}, factor=f))
    cam = look_at_matrix(list(CASC_EYE), [0.5, 0.5, 0.5])
    want, _ = jeng.render_frame(jp, jnp.asarray(bf), W, H, cam, FOCAL,
                                fine_bitfield=jnp.asarray(fine))
    got, _ = teng.render_frame(tp, torch.from_numpy(bf), W, H, cam, FOCAL,
                               fine_bitfield=torch.from_numpy(fine))
    ok = np.abs(got.numpy() - np.asarray(want)).max(-1) <= 5e-3
    assert ok.mean() >= 0.99
    assert 0.05 < float(got[..., 3].mean())
    inner_only = fine.copy()
    inner_only[1:] = bf[1:].repeat(f, 1).repeat(f, 2).repeat(f, 3)
    cost = {}
    for name, fb in (("coarse", None), ("cascade 0 fine", inner_only), ("fine", fine)):
        c, _ = teng.render_frame(tp, torch.from_numpy(bf), W, H, cam, FOCAL,
                                 fine_bitfield=None if fb is None else torch.from_numpy(fb),
                                 render_mode="cost")
        cost[name] = float(c[..., 0].sum())
    print(cost)
    assert cost["fine"] < cost["cascade 0 fine"] < cost["coarse"]
