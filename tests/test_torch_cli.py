"""The port's CLI, loaders, checkpoints and export against the JAX package,
on the CPU (--device cpu).

Clouds are written by the JAX package's own writers (.ply, KITTI .bin, .npy)
and read by both packages. The port's commands run in process.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hgmm.baselines.icp import icp as jicp
from hgmm.cli.main import main as jmain
from hgmm.data import kitti as jkitti
from hgmm.data import ply as jply
from hgmm.utils import checkpoint as jckpt
from hgmm_torch.cli.main import main
from hgmm_torch.data import kitti as tkitti
from hgmm_torch.data import ply as tply
from hgmm_torch.data.synthetic import make_cloud_np
from hgmm_torch.eval.metrics import (
    pose_delta_norm,
    registration_rmse,
    rotation_error_deg,
    translation_error,
)
from hgmm_torch.models.se3 import Pose, so3_exp
from hgmm_torch.utils import checkpoint as tckpt

torch.set_num_threads(2)

N = 3000
FIXTURE = "tests/fixtures/kitti_mini"


def _gt():
    return Pose(so3_exp(torch.tensor([0.03, -0.05, 0.08])), torch.tensor([0.02, -0.01, 0.03]))


@pytest.fixture(scope="module")
def clouds(tmp_path_factory):
    """The target and the source (target moved by the inverse ground truth)
    in all three formats."""
    d = tmp_path_factory.mktemp("clouds")
    target = make_cloud_np(N, "trefoil", seed=4)
    source = _gt().inverse().apply(torch.from_numpy(target)).numpy()
    paths = {}
    for name, pts in (("source", source), ("target", target)):
        jply.save_ply(d / f"{name}.ply", pts)
        jkitti.save_velodyne_bin(d / f"{name}.bin", pts)
        np.save(d / f"{name}.npy", pts)
        paths[name] = {ext: str(d / f"{name}.{ext}") for ext in ("ply", "bin", "npy")}
    return d, source, target, paths


def _matrix(text: str) -> np.ndarray:
    """The 4x4 matrix numpy printed before the line `final match rmse`."""
    body = text[: text.index("final match rmse")]
    return np.array(body.replace("[", " ").replace("]", " ").split(), np.float64).reshape(4, 4)


def test_icp_command_matches_jax(clouds, capsys):
    _, source, target, paths = clouds
    main(["icp", paths["source"]["ply"], paths["target"]["ply"], "--iters", "15",
          "--device", "cpu"])
    got = capsys.readouterr().out
    jmain(["icp", paths["source"]["ply"], paths["target"]["ply"], "--iters", "15"])
    ref = capsys.readouterr().out
    np.testing.assert_allclose(_matrix(got), _matrix(ref), atol=1e-4)
    res = jicp(jnp.asarray(source), jnp.asarray(target), n_iters=15)
    np.testing.assert_allclose(_matrix(got), np.asarray(res.pose.matrix()), atol=1e-4)
    assert float(got.split("final match rmse:")[1]) < 1e-3


@pytest.mark.parametrize("preset,fmt", [("config1_flat64", "npy"), ("config2_tree_8x3", "ply"),
                                        ("config3_mahalanobis", "bin")])
def test_register_command_meets_bounds(clouds, capsys, preset, fmt):
    d, source, _, paths = clouds
    out = d / f"T_{preset}.npy"
    main(["register", paths["source"][fmt], paths["target"][fmt], "--preset", preset,
          "--out", str(out), "--device", "cpu"])
    assert "converged=" in capsys.readouterr().out
    T = torch.from_numpy(np.load(out).astype(np.float32))
    pose, gt, src = Pose.from_matrix(T), _gt(), torch.from_numpy(source)
    # tests/test_register.py:45-50
    assert float(registration_rmse(pose, src, gt)) < 0.03
    assert float(rotation_error_deg(pose, gt)) < 3.0
    assert float(translation_error(pose, gt)) < 0.02
    assert float(pose_delta_norm(pose, gt)) < 0.06


def test_export_aligned_reads_back(clouds, capsys):
    d, source, target, paths = clouds
    aligned = d / "aligned.ply"
    main(["register", paths["source"]["ply"], paths["target"]["ply"], "--preset",
          "config1_flat64", "--export-aligned", str(aligned), "--device", "cpu"])
    assert f"aligned clouds -> {aligned}" in capsys.readouterr().out
    pts = jply.load_ply(aligned)
    assert pts.shape == (2 * N, 3)
    np.testing.assert_array_equal(pts[:N], target)
    np.testing.assert_allclose(pts[N:], target, atol=0.03)  # the source, moved onto the target


@pytest.mark.parametrize("tree", [False, True])
def test_fit_gmm_checkpoints_load_in_both_packages(clouds, capsys, tree):
    d, _, _, paths = clouds
    args = ["--tree", "--branch", "4", "--levels", "2"] if tree else ["--k", "8"]
    ours, theirs = d / f"ours_{tree}.npz", d / f"theirs_{tree}.npz"
    main(["fit-gmm", paths["target"]["ply"], "--out", str(ours), "--iters", "4", "--device", "cpu",
          *args])
    jmain(["fit-gmm", paths["target"]["ply"], "--out", str(theirs), "--iters", "4", *args])
    assert "saved ->" in capsys.readouterr().out
    if tree:
        for path in (ours, theirs):
            a, b = tckpt.load_tree(path, device="cpu"), jckpt.load_tree(path)
            assert a.branch == b.branch == 4 and a.n_leaves == b.n_leaves == 16
            for la, lb in zip(a.levels, b.levels):
                for x, y in zip(la, lb):
                    np.testing.assert_array_equal(x.numpy(), np.asarray(y))
        tckpt.save_tree(d / "again.npz", tckpt.load_tree(theirs, device="cpu"))
        again = jckpt.load_tree(d / "again.npz")
        np.testing.assert_array_equal(np.asarray(again.levels[1].sigma),
                                      np.asarray(jckpt.load_tree(theirs).levels[1].sigma))
    else:
        for path in (ours, theirs):
            a, b = tckpt.load_mixture(path, device="cpu"), jckpt.load_mixture(path)
            assert a.pi.shape == (8,)
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x.numpy(), np.asarray(y))


def test_odometry_checkpoint_loads_in_both_packages(tmp_path):
    poses = [Pose(so3_exp(torch.tensor([0.0, 0.0, 0.1 * i])), torch.tensor([i, 0.0, 0.0]))
             for i in range(3)]
    tckpt.save_odometry(tmp_path / "ours.npz", 2, poses[1:], poses, logliks=[-1.5, -2.5])
    frame, rel, ab, lls = jckpt.load_odometry(tmp_path / "ours.npz")
    assert frame == 2 and len(rel) == 2 and len(ab) == 3 and lls == [-1.5, -2.5]
    np.testing.assert_array_equal(np.asarray(ab[2].R), poses[2].R.numpy())
    jckpt.save_odometry(tmp_path / "theirs.npz", 2, rel, ab)
    frame, rel2, ab2, lls2 = tckpt.load_odometry(tmp_path / "theirs.npz", device="cpu")
    assert frame == 2 and len(lls2) == 2
    assert all(np.isnan(lls2))  # a file without logliks pads them with NaN
    np.testing.assert_array_equal(rel2[1].t.numpy(), poses[2].t.numpy())
    assert tckpt.load_odometry(tmp_path / "missing.npz", device="cpu") is None


def test_cuda_device_without_cuda_exits_nonzero(clouds, monkeypatch):
    _, _, _, paths = clouds
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["icp", paths["source"]["ply"], paths["target"]["ply"]],
                 ["fit-gmm", paths["target"]["ply"], "--device", "cuda"]):
        with pytest.raises(SystemExit) as exc:
            main(argv)
        assert exc.value.code not in (0, None)


@pytest.mark.parametrize("binary", [True, False])
def test_loaders_match_jax(tmp_path, binary):
    pts = make_cloud_np(500, "helix", seed=3)
    jply.save_ply(tmp_path / "c.ply", pts, binary=binary)
    np.testing.assert_array_equal(tply.load_ply(tmp_path / "c.ply"), jply.load_ply(tmp_path / "c.ply"))
    tply.save_ply(tmp_path / "d.ply", pts, binary=binary)
    np.testing.assert_array_equal(jply.load_ply(tmp_path / "d.ply"), tply.load_ply(tmp_path / "c.ply"))
    scans = tkitti.sequence_scan_paths(FIXTURE)
    assert [p.name for p in scans] == [p.name for p in jkitti.sequence_scan_paths(FIXTURE)]
    for p in scans:
        a, b = tkitti.load_velodyne_bin(p), jkitti.load_velodyne_bin(p)
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(tkitti.voxel_downsample(a, 0.3),
                                      jkitti.voxel_downsample(b, 0.3))
    for a, b in zip(tkitti.load_poses(f"{FIXTURE}/poses.txt", device="cpu"),
                    jkitti.load_poses(f"{FIXTURE}/poses.txt")):
        np.testing.assert_array_equal(a.R.numpy(), np.asarray(b.R))
        np.testing.assert_array_equal(a.t.numpy(), np.asarray(b.t))
    a = tkitti.load_calib_velo_to_cam(f"{FIXTURE}/calib.txt", device="cpu")
    b = jkitti.load_calib_velo_to_cam(f"{FIXTURE}/calib.txt")
    np.testing.assert_array_equal(a.R.numpy(), np.asarray(b.R))
    np.testing.assert_array_equal(a.t.numpy(), np.asarray(b.t))
