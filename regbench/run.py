"""Run one cell of the benchmark of hgmm_torch, the PyTorch and CUDA port, once.

    python3 regbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds BENCHMARK.json, regbench/ and
hgmm_torch/, on a machine with an NVIDIA GPU. The cell is the entry of
BENCHMARK.json's "workloads" named by --workload; its configuration, traffic
mix, entry, limits and per-layer readers are found by name under regbench/
(regbench/harness/layout.py). The inputs are made from --seed. After set-up
(import, the CUDA context, loading the kernel libraries, the inputs, the
warm-up; a checkout's first run also compiles them, timed apart) the
program is driven for --seconds in a closed loop (--trace 0) or through a
short profiled stretch (--trace 1); what it produced is then compared with the
plain reference under regbench/reference/. The program builds its kernels
and its native reader into hgmm_torch/_build/ inside the checkout, so only a
checkout's first run compiles.

Prints an information line, then as its last line on standard output one
JSON object: correct, attempted, failed, metrics (the cell's end-to-end
metrics with --trace 0, its per-layer metrics with --trace 1), device, the
breakdown of the trace with --trace 1, and last "checks": each number compared
with its limit. The comparisons are also the last lines on standard error.
Exits 2 without a CUDA device (nothing falls back to the CPU), 3 when the
process holds jax or the JAX package hgmm.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# One host thread for the CPU-side operations of torch and numpy: the card's
# host is shared, and a pool of eight threads made the pairs' rate spread
# three times as widely (PERF.md, "Cells").
THREADS = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1", "OPENBLAS_NUM_THREADS": "1"}


def _finite(x):
    return x if isinstance(x, (int, float)) and math.isfinite(x) else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0:
        ap.error("--seed must be a whole number >= 0")
    os.environ.update(THREADS)
    sys.path.insert(0, str(ROOT))
    import torch

    torch.set_num_threads(1)

    from regbench.harness import cell, layout

    if not torch.cuda.is_available():
        print("regbench: CUDA is not available; the benchmark runs on the card only", file=sys.stderr)
        return 2
    try:
        out = cell.run(layout.Layout(ROOT), args.workload, args.seed, args.seconds, bool(args.trace),
                       "cuda", T_PROCESS)
    except cell.NoCard as e:
        print(f"regbench: {e}", file=sys.stderr)
        return 2
    result = out["result"]
    cell.guard("before the result")
    for c in (*result["checks"].values(), *result["metrics"].values()):
        c["value"] = _finite(c["value"])
    print(json.dumps({"info": out["info"]}), flush=True)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
