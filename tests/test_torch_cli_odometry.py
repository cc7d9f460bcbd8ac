"""The port's `odometry` and `localize` commands in process with --device cpu
on the checked-in KITTI-format fixture, with the arguments and bounds of
tests/test_kitti_e2e.py:56-116."""

import functools
import json
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from hgmm_torch.cli.main import main
from hgmm_torch.pipelines import mapping
from hgmm_torch.utils.checkpoint import load_tree

torch.set_num_threads(2)

FIXTURE = Path(__file__).parent / "fixtures" / "kitti_mini"
TREE_ARGS = ["--max-frames", "3", "--voxel", "0.25", "--bucket", "4096", "--fit-iters", "8",
             "--reg-iters", "20", "--device", "cpu"]


def _ate(out: str) -> float:
    return float(out.split("ATE vs ground truth:")[1].split("m")[0])


def test_flat_model(tmp_path, capsys):
    """tests/test_kitti_e2e.py:56-77."""
    out = tmp_path / "traj_flat.npy"
    main(["odometry", str(FIXTURE), "--model", "flat", "--max-frames", "3", "--voxel", "0.25",
          "--bucket", "2048", "--fit-iters", "6", "--reg-iters", "15", "--out", str(out),
          "--device", "cpu"])
    assert "3 poses in" in capsys.readouterr().out
    traj = np.load(out)
    assert traj.shape == (3, 3)
    assert 0.2 < traj[1, 0] < 0.6, traj


@pytest.fixture(scope="module")
def tree_run(tmp_path_factory):
    """tests/test_kitti_e2e.py:80-116, with a checkpoint, run twice: the
    second run resumes the finished chain."""
    d = tmp_path_factory.mktemp("odo")
    outs = []
    for k in range(2):
        argv = ["odometry", str(FIXTURE), *TREE_ARGS, "--out", str(d / f"traj{k}.npy"),
                "--poses", str(FIXTURE / "poses.txt"), "--metrics", str(d / f"m{k}.jsonl"),
                "--checkpoint", str(d / "ck.npz")]
        with pytest.MonkeyPatch.context() as mp:
            lines = []
            mp.setattr("builtins.print", lambda *a, **k: lines.append(" ".join(map(str, a))))
            main(argv)
        outs.append("\n".join(lines))
    return d, outs


def test_ate_and_trajectory(tree_run):
    d, outs = tree_run
    ate = _ate(outs[0])
    assert ate < 0.1, outs[0]  # frame spacing is 0.4 m
    traj = np.load(d / "traj0.npy")
    assert traj.shape == (3, 3)
    assert 0.25 < traj[1, 0] < 0.55 and 0.6 < traj[2, 0] < 1.0, traj


def test_metrics_events(tree_run):
    d, outs = tree_run
    records = [json.loads(line) for line in (d / "m0.jsonl").read_text().splitlines()]
    events = [r["event"] for r in records]
    assert events == ["registration", "registration", "ate"]
    reg = records[0]
    assert reg["name"] == "pair_0_1" and len(reg["logliks"]) == 3 * 20
    assert isinstance(reg["converged"], bool)
    ate = records[-1]
    assert ate["frames"] == 3 and ate["ate_m"] == pytest.approx(_ate(outs[0]), abs=1e-3)
    assert ate["refined"] is False


def test_checkpoint_resumes(tree_run):
    """The second run registers no pair and writes the same trajectory."""
    d, outs = tree_run
    events = [json.loads(line)["event"] for line in (d / "m1.jsonl").read_text().splitlines()]
    assert events == ["ate"]
    np.testing.assert_array_equal(np.load(d / "traj1.npy"), np.load(d / "traj0.npy"))
    assert _ate(outs[1]) == _ate(outs[0])


def test_refine_map_then_localize(tree_run, capsys, monkeypatch):
    """--refine --map, then `localize` of frame 0 against the map recovers
    ~identity (frame 0 is the world origin). The map fit's point bucket is cut
    from 2^18 to 2^14 for the CPU."""
    d, _ = tree_run
    monkeypatch.setattr(mapping, "MapConfig", functools.partial(mapping.MapConfig, bucket=1 << 14))
    map_p, plot = d / "map.npz", d / "traj.png"
    main(["odometry", str(FIXTURE), *TREE_ARGS, "--out", str(d / "traj_ref.npy"), "--refine",
          "--map", str(map_p), "--plot", str(plot), "--poses", str(FIXTURE / "poses.txt")])
    out = capsys.readouterr().out
    assert "global map (512 leaves) ->" in out and "trajectory plot ->" in out
    assert _ate(out) < 0.1
    tree = load_tree(map_p)
    assert int((tree.leaf_mixture().pi > 0).sum()) >= 64
    loc = d / "loc.npy"
    main(["localize", str(FIXTURE / "velodyne" / "000000.bin"), str(map_p), "--iters", "25",
          "--out", str(loc), "--device", "cpu"])
    assert "scan->map transform:" in capsys.readouterr().out
    T = np.load(loc)
    assert np.linalg.norm(T[:3, 3]) < 0.05, T
    assert abs(np.trace(T[:3, :3]) - 3.0) < 0.05, T


@pytest.fixture
def gloo_world():
    """--sharded on the CPU makes a gloo world of one process when there is
    no process group; take down the one this test made."""
    made = not dist.is_initialized()
    yield
    if made and dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.parametrize("cmd", ["odometry", "localize"])
def test_sharded_matches_unsharded(cmd, tree_run, gloo_world, tmp_path, capsys):
    """`odometry --sharded` and `localize --sharded` over a world of one
    process print what the unsharded commands print, within float rounding
    (the sharded fit sums its covariance floor's moments in float64)."""
    d, outs = tree_run
    if cmd == "odometry":
        out = tmp_path / "traj.npy"
        main(["odometry", str(FIXTURE), *TREE_ARGS, "--out", str(out), "--poses",
              str(FIXTURE / "poses.txt"), "--sharded"])
        np.testing.assert_allclose(np.load(out), np.load(d / "traj0.npy"), atol=1e-4)
        assert _ate(capsys.readouterr().out) == pytest.approx(_ate(outs[0]), abs=1e-4)
        return
    from hgmm_torch.data.kitti import load_velodyne_bin, voxel_downsample
    from hgmm_torch.models.gmm_tree import GmmTree
    from hgmm_torch.utils.checkpoint import save_tree

    scan = FIXTURE / "velodyne" / "000000.bin"
    pts = torch.from_numpy(voxel_downsample(load_velodyne_bin(scan), 0.25))
    tree, _ = GmmTree.fit(pts, levels=2, em_iters=6, generator=torch.Generator().manual_seed(0))
    save_tree(tmp_path / "map.npz", tree)
    got = []
    for extra in ([], ["--sharded"]):
        main(["localize", str(scan), str(tmp_path / "map.npz"), "--iters", "20", "--out",
              str(tmp_path / "T.npy"), "--device", "cpu", *extra])
        got.append(np.load(tmp_path / "T.npy"))
    assert "scan->map transform:" in capsys.readouterr().out
    np.testing.assert_allclose(got[1], got[0], atol=1e-5)


@pytest.mark.parametrize("cmd", [["odometry", str(FIXTURE)],
                                 ["localize", str(FIXTURE / "velodyne" / "000000.bin"), "m.npz"]])
def test_cuda_device_without_cuda_exits_nonzero(cmd, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        main(cmd)
    assert exc.value.code not in (0, None)
