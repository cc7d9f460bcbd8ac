"""A copy of the benchmark's layout at sizes a CPU test run can hold: the
same files, with the configurations' and traffic mixes' sizes cut."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

SMALL = {
    "configs/dragon_tree_8x3.json": {"points": 6000},
    "configs/kitti_hdl64_8x3.json": {"frames": 4, "scan_points": 12000, "world_points": 40000},
    "traffic/pair_pool8.json": {"pool": 1, "check_pairs": 1, "warm_requests": 1},
    "traffic/map_pool8.json": {"pool": 1, "check_pairs": 1, "warm_requests": 1},
    "traffic/chain_dense.json": {"bucket": 8192, "warm_frames": 2},
}


def edit(path: Path, **changes) -> None:
    d = json.loads(path.read_text())
    d.update(changes)
    path.write_text(json.dumps(d, indent=1))


def copy_layout(dst: Path, small: bool = True) -> Path:
    """BENCHMARK.json and regbench/ copied to dst; with small, at CPU sizes."""
    shutil.copy(REPO / "BENCHMARK.json", dst / "BENCHMARK.json")
    shutil.copytree(REPO / "regbench", dst / "regbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    if small:
        for rel, changes in SMALL.items():
            edit(dst / "regbench" / rel, **changes)
    return dst
