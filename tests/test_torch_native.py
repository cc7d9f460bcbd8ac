"""hgmm_torch.data.native, the port's copy of the C++ reader, against the
port's numpy paths and the JAX package's loaders, bit for bit.

The library is built with g++ into a temporary copy of the build directory
(skipped only where g++ is absent, as tests/test_data.py skips).
"""

import shutil

import numpy as np
import pytest

from hgmm.data.kitti import load_velodyne_bin as ref_load_bin
from hgmm.data.kitti import voxel_downsample as ref_voxel
from hgmm.data.ply import load_ply as ref_load_ply
from hgmm_torch.data import kitti, native, ply
from hgmm_torch.data.synthetic import make_cloud_np


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """native with its library built into a temporary build directory."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not available")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(native, "BUILD_DIR", tmp_path_factory.mktemp("build") / "_build")
        native.build(verbose=False)
        assert native.available()
        yield native


def numpy_path(fn, *args, **kwargs):
    """fn through the port's numpy path (the native library hidden)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(native, "available", lambda: False)
        return fn(*args, **kwargs)


def lidar_points(n, seed=0, extent=40.0):
    """[n, 3] float32 in +-extent metres: a ground plane, walls and scatter."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-extent, extent, (n, 3))
    pts[: n // 3, 2] = -1.7 + rng.normal(0.0, 0.02, n // 3)
    pts[n // 3: n // 2, 1] = 25.0 + rng.normal(0.0, 0.02, n // 2 - n // 3)
    return pts.astype(np.float32)


def test_build_keys_the_library_and_reuses_it(built):
    path = built.library_path()
    assert path.parent == built.BUILD_DIR and path.exists()
    assert path.name.startswith("libhgmm_io-") and len(path.stem) == len("libhgmm_io-") + 16
    mtime = path.stat().st_mtime_ns
    assert built.build(verbose=False) == path and path.stat().st_mtime_ns == mtime
    assert [p.name for p in built.BUILD_DIR.iterdir()] == [path.name]  # no temporary left


@pytest.mark.parametrize("n", [1, 5000, 120_000])
def test_load_kitti_bin_bit_equal(built, tmp_path, n):
    pts = lidar_points(n, seed=n)
    p = tmp_path / "000000.bin"
    kitti.save_velodyne_bin(p, pts)
    out = built.load_kitti_bin(str(p))
    assert out is not None and out.dtype == np.float32
    np.testing.assert_array_equal(out, pts)
    np.testing.assert_array_equal(out, numpy_path(kitti.load_velodyne_bin, p))
    np.testing.assert_array_equal(out, ref_load_bin(p))
    np.testing.assert_array_equal(kitti.load_velodyne_bin(p), out)


def test_load_kitti_bin_ragged_and_empty_files(built, tmp_path):
    ragged = tmp_path / "ragged.bin"
    np.zeros(7, "<f4").tofile(ragged)
    assert built.load_kitti_bin(str(ragged)) is None
    with pytest.raises(ValueError, match="not divisible by 4"):
        kitti.load_velodyne_bin(ragged)
    empty = tmp_path / "empty.bin"
    empty.write_bytes(b"")
    assert built.load_kitti_bin(str(empty)) is None
    assert kitti.load_velodyne_bin(empty).shape == (0, 3)
    with pytest.raises(FileNotFoundError):
        kitti.load_velodyne_bin(tmp_path / "missing.bin")


def _write_ply(path, fields, rows, fmt="binary_little_endian"):
    """A PLY of `rows` (a numpy structured array) with property lines from
    `fields` [(ply type, name)]."""
    header = (f"ply\nformat {fmt} 1.0\nelement vertex {rows.shape[0]}\n"
              + "".join(f"property {t} {name}\n" for t, name in fields)
              + "element face 0\nproperty list uchar int vertex_indices\nend_header\n")
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(rows.tobytes())


@pytest.mark.parametrize("n", [3, 4_000_003])  # past 4M points the copy runs on threads
def test_load_ply_binary_bit_equal(built, tmp_path, n):
    pts = make_cloud_np(n, "trefoil", seed=1) * 40.0
    p = tmp_path / "cloud.ply"
    ply.save_ply(p, pts)
    out = built.load_ply(str(p))
    assert out is not None
    np.testing.assert_array_equal(out, pts)
    np.testing.assert_array_equal(out, numpy_path(ply.load_ply, p))
    np.testing.assert_array_equal(out, ref_load_ply(p))
    np.testing.assert_array_equal(ply.load_ply(p), out)


def test_load_ply_with_other_properties(built, tmp_path):
    """x, y, z after a uchar and before normals and a short: read natively."""
    rng = np.random.default_rng(2)
    dt = np.dtype([("flag", "u1"), ("x", "<f4"), ("y", "<f4"), ("z", "<f4"), ("nx", "<f4"),
                   ("ny", "<f4"), ("nz", "<f4"), ("label", "<i2")])
    rows = np.zeros(1001, dt)
    for name in ("x", "y", "z", "nx", "ny", "nz"):
        rows[name] = rng.normal(size=1001).astype(np.float32)
    rows["flag"], rows["label"] = 7, -3
    p = tmp_path / "props.ply"
    _write_ply(p, [("uchar", "flag"), ("float", "x"), ("float", "y"), ("float", "z"),
                   ("float", "nx"), ("float", "ny"), ("float", "nz"), ("short", "label")], rows)
    out = built.load_ply(str(p))
    assert out is not None
    want = np.stack([rows["x"], rows["y"], rows["z"]], 1)
    np.testing.assert_array_equal(out, want)
    np.testing.assert_array_equal(out, numpy_path(ply.load_ply, p))
    np.testing.assert_array_equal(out, ref_load_ply(p))


@pytest.mark.parametrize("kind", ["ascii", "big_endian", "double"])
def test_load_ply_layouts_the_native_reader_leaves_to_numpy(built, tmp_path, kind):
    """Native returns None; the loader still reads the file, as the JAX
    package's does (ascii to its printed precision)."""
    pts = np.random.default_rng(3).normal(size=(200, 3)).astype(np.float32)
    p = tmp_path / f"{kind}.ply"
    if kind == "ascii":
        ply.save_ply(p, pts, binary=False)
    elif kind == "big_endian":
        rows = pts.astype(">f4").view([("x", ">f4"), ("y", ">f4"), ("z", ">f4")]).ravel()
        _write_ply(p, [("float", "x"), ("float", "y"), ("float", "z")], rows, "binary_big_endian")
    else:
        rows = pts.astype("<f8").view([("x", "<f8"), ("y", "<f8"), ("z", "<f8")]).ravel()
        _write_ply(p, [("double", "x"), ("double", "y"), ("double", "z")], rows)
    assert built.load_ply(str(p)) is None
    out = ply.load_ply(p)
    np.testing.assert_array_equal(out, ref_load_ply(p))
    np.testing.assert_array_equal(out, numpy_path(ply.load_ply, p))
    if kind == "ascii":
        np.testing.assert_allclose(out, pts, rtol=1e-6, atol=1e-7)  # "%.7g"
    else:
        np.testing.assert_array_equal(out, pts)


@pytest.mark.parametrize("voxel", [0.05, 0.3, 2.0])
def test_voxel_downsample_bit_equal(built, voxel):
    pts = lidar_points(120_000, seed=4)
    out = built.voxel_downsample(pts, voxel)
    assert out is not None and out.dtype == np.float32 and 0 < out.shape[0] <= pts.shape[0]
    np.testing.assert_array_equal(out, numpy_path(kitti.voxel_downsample, pts, voxel))
    np.testing.assert_array_equal(out, ref_voxel(pts, voxel))
    np.testing.assert_array_equal(kitti.voxel_downsample(pts, voxel), out)


def test_voxel_downsample_arguments_the_native_path_leaves(built):
    pts = lidar_points(100, seed=5)
    assert built.voxel_downsample(pts[:0], 0.3) is None
    assert built.voxel_downsample(pts, 0.0) is None
    assert kitti.voxel_downsample(pts[:0], 0.3).shape == (0, 3)
    with pytest.raises(ValueError, match=r"not \[N, 3\]"):
        built.voxel_downsample(pts[:, :2], 0.3)


def test_loaders_go_through_native_when_built(built, tmp_path, monkeypatch):
    calls = []
    for name in ("load_kitti_bin", "load_ply", "voxel_downsample"):
        fn = getattr(native, name)
        monkeypatch.setattr(native, name, lambda *a, _fn=fn, _name=name: calls.append(_name) or _fn(*a))
    pts = lidar_points(64, seed=6)
    kitti.save_velodyne_bin(tmp_path / "a.bin", pts)
    ply.save_ply(tmp_path / "a.ply", pts)
    kitti.load_velodyne_bin(tmp_path / "a.bin")
    ply.load_ply(tmp_path / "a.ply")
    kitti.voxel_downsample(pts, 0.3)
    assert calls == ["load_kitti_bin", "load_ply", "voxel_downsample"]


def test_no_library_means_the_numpy_path(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    assert not native.available()
    assert native.load_kitti_bin(str(tmp_path / "x.bin")) is None
    assert native.voxel_downsample(lidar_points(10), 0.3) is None
    pts = lidar_points(500, seed=7)
    kitti.save_velodyne_bin(tmp_path / "a.bin", pts)
    np.testing.assert_array_equal(kitti.load_velodyne_bin(tmp_path / "a.bin"), pts)


def test_a_library_that_fails_to_load_raises(tmp_path, monkeypatch):
    """Never a silent numpy run: a broken library fails every loader."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    native.BUILD_DIR.mkdir()
    native.library_path().write_bytes(b"not a shared library")
    pts = lidar_points(50, seed=8)
    kitti.save_velodyne_bin(tmp_path / "a.bin", pts)
    ply.save_ply(tmp_path / "a.ply", pts)
    with pytest.raises(OSError):
        native.available()
    with pytest.raises(OSError):
        kitti.load_velodyne_bin(tmp_path / "a.bin")
    with pytest.raises(OSError):
        ply.load_ply(tmp_path / "a.ply")
    with pytest.raises(OSError):
        kitti.voxel_downsample(pts, 0.3)
