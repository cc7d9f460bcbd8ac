"""The control of a cell's correctness check: the plain reference put in the
program's place, computed in the nearest precision below the configuration's
(float32 with TF32 matrix products, where the configuration states float32
with TF32 off), and compared with the float64 reference exactly as the
program's outputs are. Its numbers have to fail the cell's limits; they are
the upper readings the limits were set below (PERF.md).

    python3 -m regbench.harness.control --workload <name> --seeds <n> [<n> ...]

On a machine with an NVIDIA GPU, from the root of a checkout; prints one JSON
line a seed with the numbers and the cell's limits. The benchmark's own runs
never run it.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time


@contextlib.contextmanager
def tf32():
    """Matrix products in TF32 (10-bit mantissa) inside the block."""
    import torch

    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def readings(layout, workload: str, seed: int, device: str) -> dict:
    """The control's numbers in one cell for one seed, at the cell's sizes."""
    cell = layout.cell(workload)
    traffic = layout.traffic(cell["traffic"])
    entry = layout.entry(traffic["entry"]).Entry(layout.config(cell["config"]), traffic, seed, device)
    entry.inputs()
    return entry.control(tf32)


def main(argv=None) -> int:
    from regbench.harness import layout

    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    lay = layout.Layout()
    limits = {k: v["limit"] for k, v in lay.limits(args.workload).items()}
    for seed in args.seeds:
        t0 = time.perf_counter()
        got = readings(lay, args.workload, seed, "cuda")
        print(json.dumps({"workload": args.workload, "seed": seed, "control": got, "limits": limits,
                          "fails": [k for k, v in got.items() if not v <= limits.get(k, float("inf"))],
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
