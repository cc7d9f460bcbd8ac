"""hgmm_torch.pipelines.mapping and viz.export against the JAX package on
the CPU, on the loop sequence of tests/test_loop_closure.py rebuilt with
numpy and one numpy init in both packages (_torch_parity.same_init)."""

import importlib.util

import numpy as np
import pytest
import torch

from _torch_parity import loop_sequence, same_init, to_jax_pose  # noqa: F401
from hgmm.data import ply as jply
from hgmm.pipelines import mapping as jmap
from hgmm.viz import export as jexport
from hgmm_torch import convert
from hgmm_torch.data.synthetic import make_cloud_np
from hgmm_torch.eval.metrics import pose_delta_norm
from hgmm_torch.models.se3 import Pose, so3_exp
from hgmm_torch.ops import em_ref
from hgmm_torch.ops.gaussians import pack_loglik_weights
from hgmm_torch.pipelines import mapping as tmap
from hgmm_torch.viz import export as texport

torch.set_num_threads(2)

MAP = dict(levels=2, em_iters=8, bucket=4096, voxel=0)


@pytest.fixture(scope="module")
def maps(same_init):
    frames, gt = loop_sequence(n_frames=12)
    ref = jmap.build_map(frames, [to_jax_pose(p) for p in gt], jmap.MapConfig(**MAP))
    got = tmap.build_map(frames, gt, tmap.MapConfig(**MAP))
    return frames, gt, ref, got


def test_fuse_frames_is_bit_equal():
    frames, gt = loop_sequence(n_frames=6)
    padded = [(np.concatenate([f, np.full((9, 3), 9.9, np.float32)]),
               np.concatenate([np.ones(len(f), np.float32), np.zeros(9, np.float32)]))
              for f in frames]
    jgt = [to_jax_pose(p) for p in gt]
    for fr, voxel in ((frames, 0), (padded, 0), (frames, None), (frames, 0.05)):
        got, ref = tmap.fuse_frames(fr, gt, voxel=voxel), jmap.fuse_frames(fr, jgt, voxel=voxel)
        assert got.dtype == ref.dtype == np.float32
        np.testing.assert_array_equal(got, ref)
    with pytest.raises(ValueError, match="frames vs"):
        tmap.fuse_frames(frames, gt[:2])


def test_build_map_matches_jax(maps):
    _, _, ref, got = maps
    assert got.n_leaves == ref.n_leaves == 64
    for a, b in zip(got.levels, ref.levels):
        for x, y in zip(a, b):
            np.testing.assert_allclose(x.numpy(), np.asarray(y), atol=1e-4)


def test_localize_on_the_jax_map(maps):
    """tests/test_mapping.py:39-63: a held-out view between frames 0 and 1,
    localized against the JAX map carried across, by both packages."""
    _, _, ref, _ = maps
    carried = convert.tree_from_numpy([tuple(np.asarray(a) for a in lvl) for lvl in ref.levels],
                                      ref.branch, device="cpu")
    th = np.pi / 12.0
    radius = 0.09 * 12 / (2 * np.pi)
    hp = Pose(so3_exp(torch.tensor([0.0, 0.0, 0.3 * np.sin(th)], dtype=torch.float32)),
              torch.tensor([radius * np.cos(th) - radius, radius * np.sin(th), 0.0],
                           dtype=torch.float32))
    scan = hp.inverse().apply(torch.from_numpy(make_cloud_np(4000, "trefoil", seed=0))).numpy()
    scan = scan[np.abs(np.arctan2(scan[:, 1], scan[:, 0])) < 1.6]
    scan = scan + 0.004 * np.random.default_rng(99).standard_normal(scan.shape).astype(np.float32)
    got = tmap.localize(scan, carried, n_iters=25, outlier_logit=-3.0)
    jres = jmap.localize(scan, ref, n_iters=25, outlier_logit=-3.0)
    jp = Pose(torch.from_numpy(np.asarray(jres.pose.R)), torch.from_numpy(np.asarray(jres.pose.t)))
    assert float(pose_delta_norm(got.pose, jp)) < 1e-5
    assert float(torch.linalg.norm(got.pose.t - hp.t)) < 0.02  # tests/test_mapping.py:62


def test_sample_mixture_is_bit_equal(maps):
    _, _, ref, _ = maps
    leaves = ref.leaf_mixture()
    carried = convert.mixture_from_numpy(*(np.asarray(a) for a in leaves), device="cpu")
    got = tmap.sample_mixture(carried, 700, seed=3)
    np.testing.assert_array_equal(got, jmap.sample_mixture(leaves, 700, seed=3))


def test_update_map_matches_jax(maps):
    """Warm start from the map's level 0, new frames plus carried samples."""
    frames, gt, ref, got = maps
    new_frames, new_gt = loop_sequence(n_frames=4, seed=1)
    cfg = dict(MAP, bucket=8192)
    a = tmap.update_map(got, new_frames, new_gt, tmap.MapConfig(**cfg))
    b = jmap.update_map(ref, new_frames, [to_jax_pose(p) for p in new_gt], jmap.MapConfig(**cfg))
    probe = torch.from_numpy(frames[0][:512])

    def ll(tree):
        W = pack_loglik_weights(convert.mixture_from_numpy(*(np.asarray(x) for x in tree.leaf_mixture()), device="cpu"))
        return float(em_ref.em_stats(probe, W).loglik) / 512

    np.testing.assert_allclose(ll(a), ll(b), rtol=1e-3)
    with pytest.raises(ValueError, match="warm start"):
        tmap.update_map(got, new_frames, new_gt, tmap.MapConfig(**dict(cfg, branch=4)))


def test_export_map_and_trajectory(maps, tmp_path):
    frames, gt, ref, got = maps
    for mod, tree, name in ((texport, got, "ours"), (jexport, ref, "theirs")):
        mod.export_map(tmp_path / f"{name}.ply", tree, samples_per_leaf=8)
    ours, theirs = jply.load_ply(tmp_path / "ours.ply"), jply.load_ply(tmp_path / "theirs.ply")
    n_live = int((got.leaf_mixture().pi > 0).sum())
    assert ours.shape == (n_live * 9, 3) and np.all(np.isfinite(ours))
    assert ours.shape == theirs.shape
    # Same tree -> same PLY.
    carried = convert.tree_from_numpy([tuple(np.asarray(a) for a in lvl) for lvl in ref.levels],
                                      ref.branch, device="cpu")
    texport.export_map(tmp_path / "carried.ply", carried, samples_per_leaf=8)
    np.testing.assert_allclose(jply.load_ply(tmp_path / "carried.ply"), theirs, atol=1e-5)
    png = tmp_path / "traj.png"
    closures = type("E", (), {"i": torch.tensor([0]), "j": torch.tensor([11])})()
    texport.export_trajectory(png, gt, gt_poses=gt, refined_poses=gt, closures=closures)
    # The plot is skipped where matplotlib is absent, as in the JAX package.
    has_mpl = importlib.util.find_spec("matplotlib") is not None
    assert png.exists() == has_mpl and (not has_mpl or png.stat().st_size > 0)


def test_build_map_localize_and_update_through_mesh(maps):
    """tests/test_mapping.py:67: the map fit through sharded_tree_fit and
    localization through sharded_register_tree, by hgmm (its 8 fake devices)
    and the port (3 ranks emulated on the CPU); the port's mesh map against
    its unsharded one and hgmm's mesh map, and update_map through the mesh."""
    from hgmm.parallel import make_mesh
    from hgmm_torch.parallel import EmulatedMesh

    frames, gt, _, single = maps
    mesh = EmulatedMesh(3, "cpu")
    cfg = tmap.MapConfig(**MAP)
    got = tmap.build_map(frames, gt, cfg, mesh=mesh)
    ref = jmap.build_map(frames, [to_jax_pose(p) for p in gt], jmap.MapConfig(**MAP), mesh=make_mesh())
    for other in (single.levels[-1].mu.numpy(), np.asarray(ref.levels[-1].mu)):
        np.testing.assert_allclose(got.levels[-1].mu.numpy(), other, atol=1e-3)
    th = np.pi / 12.0
    radius = 0.09 * 12 / (2 * np.pi)
    hp = Pose(so3_exp(torch.tensor([0.0, 0.0, 0.3 * np.sin(th)], dtype=torch.float32)),
              torch.tensor([radius * np.cos(th) - radius, radius * np.sin(th), 0.0],
                           dtype=torch.float32))
    scan = hp.inverse().apply(torch.from_numpy(make_cloud_np(4000, "trefoil", seed=0))).numpy()
    scan = scan[np.abs(np.arctan2(scan[:, 1], scan[:, 0])) < 1.6]
    scan = scan + 0.004 * np.random.default_rng(99).standard_normal(scan.shape).astype(np.float32)
    res = tmap.localize(scan, got, mesh=mesh, n_iters=25, outlier_logit=-3.0)
    plain = tmap.localize(scan, got, n_iters=25, outlier_logit=-3.0)
    assert float(pose_delta_norm(res.pose, plain.pose)) < 1e-4
    assert float(torch.linalg.norm(res.pose.t - hp.t)) < 0.02  # tests/test_mapping.py:90
    new_frames, new_gt = loop_sequence(n_frames=4, seed=1)
    ucfg = tmap.MapConfig(**dict(MAP, bucket=8192))
    a = tmap.update_map(got, new_frames, new_gt, ucfg, mesh=mesh)
    b = tmap.update_map(got, new_frames, new_gt, ucfg)
    np.testing.assert_allclose(a.levels[0].mu.numpy(), b.levels[0].mu.numpy(), atol=1e-3)
