"""hgmm_torch stands alone: it imports neither jax nor hgmm, builds nothing
at import, and on CPU tensors never touches a kernel."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]


def test_import_leaves_no_jax_or_hgmm_module():
    prog = (
        "import sys, hgmm_torch, hgmm_torch.convert, hgmm_torch.ops.fused_em\n"
        "import hgmm_torch.bench, hgmm_torch.ops.probes, hgmm_torch.eval.roofline\n"
        "import hgmm_torch.utils.timing, hgmm_torch.utils.device, hgmm_torch.cli.main\n"
        "import hgmm_torch.benchmarks.mxu_microbench, hgmm_torch.benchmarks.vpu_microbench\n"
        "import hgmm_torch.benchmarks.kernel_shapes, hgmm_torch.benchmarks.trace_accounting\n"
        "import hgmm_torch.parallel, hgmm_torch.benchmarks.large_n\n"
        "import hgmm_torch.data.native, hgmm_torch.data.kitti, hgmm_torch.data.ply\n"
        "import hgmm_torch.benchmarks.registration_suite, hgmm_torch.benchmarks.odometry_suite\n"
        "import hgmm_torch.benchmarks.scaling\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'hgmm', 'benchmarks')]\n"
        "assert not bad, bad\n"
        "import hgmm_torch.ops._build as b\n"
        "assert b._lib is None\n"
        "import hgmm_torch.data.native as n\n"
        "assert not n._handles and not n._key.cache_info().currsize\n"
        "print('clean')\n"
    )
    r = subprocess.run([sys.executable, "-c", prog], cwd=REPO, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0 and "clean" in r.stdout, r.stderr


def test_no_source_file_imports_jax_or_hgmm():
    """Every module of the port (the bench path's included) and chip_smoke.py."""
    paths = sorted((REPO / "hgmm_torch").rglob("*.py"))
    for new in ("bench.py", "ops/probes.py", "eval/roofline.py", "utils/timing.py",
                "benchmarks/mxu_microbench.py", "benchmarks/vpu_microbench.py",
                "benchmarks/kernel_shapes.py", "benchmarks/trace_accounting.py",
                "parallel/__init__.py", "parallel/mesh.py", "parallel/sharded.py",
                "benchmarks/large_n.py", "data/native.py", "benchmarks/registration_suite.py",
                "benchmarks/odometry_suite.py", "benchmarks/scaling.py"):
        assert REPO / "hgmm_torch" / new in paths
    for path in paths + [REPO / "chip_smoke.py"]:
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for name in names:
                assert name.split(".")[0] not in ("jax", "jaxlib", "hgmm", "benchmarks"), (path, name)


def test_cpu_path_launches_no_kernel():
    from hgmm_torch.data.synthetic import make_cloud
    from hgmm_torch.models.gmm_tree import GmmTree
    from hgmm_torch.ops import fused_em
    from hgmm_torch.pipelines.register import register_tree

    fused_em.reset_launches()
    pts = make_cloud(800, "helix", seed=1, device="cpu")
    tree, _ = GmmTree.fit(pts, branch=8, levels=2, em_iters=3,
                          generator=torch.Generator().manual_seed(0))
    register_tree(pts, tree, n_iters=4, method="horn+wls")
    assert all(c == 0 for c in fused_em.LAUNCHES.values()), fused_em.LAUNCHES


@pytest.mark.parametrize("name", ["em_stats", "em_stats_masked", "assign", "reg_stats"])
def test_kernel_wrappers_refuse_cpu_tensors(name):
    """A wrapper launches on CUDA tensors or raises; it never falls back."""
    from hgmm_torch.ops import fused_em

    pts4 = torch.zeros(4, 16)
    W = torch.zeros(10, 8)
    args = {
        "em_stats": (pts4, W),
        "em_stats_masked": (pts4, W, torch.zeros(16, dtype=torch.int32), 8),
        "assign": (pts4, W),
        "reg_stats": (pts4, W, torch.zeros(8, 3), torch.zeros(8, 6), torch.zeros(8, 3),
                      (torch.eye(3), torch.zeros(3))),
    }[name]
    with pytest.raises(ValueError, match="CUDA"):
        getattr(fused_em, name)(*args)
