#!/usr/bin/env python3
"""Smoke run of hgmm_torch, the PyTorch/CUDA port, on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --probe-checks   # steps 1-3 and probe_checks only
    python3 chip_smoke.py --sharded-only   # steps 1-2, pair_accounting and step 9
    python3 chip_smoke.py --suites-only    # steps 1-3, step 10 and the native phase

Run from the root of a checkout. It
1. prints the card's name and power limit (nvidia-smi) and fails without CUDA;
2. builds the CUDA kernels of hgmm_torch/csrc with nvcc (timed) and prints the
   registers and spill bytes of every redesigned kernel (REPORTED_KERNELS)
   from the -Xptxas -v log, and the tensor-core instructions (HGMMA, HMMA) in
   the SASS of every probe kernel (cuobjdump); a spill fails the run, and so
   does a bf16 logits, stats or norm kernel (WGMMA_KERNELS) without HGMMA,
   with HMMA, or with its wgmma serialized by ptxas; it prints the instructions a
   step of probe_vpu's busiest loop issues, by kind, and fails if an exp2
   body holds no MUFU.EX2 or more conversions a step than the design's one
   packed convert (ops/probes.py:VPU_CONVERTS), or any kernel of the probe
   the single convert F2F; and it prints the adds an element and rep in
   probe_addonly's busiest loop (ops/probes.py:addonly_sass_counts) and fails
   unless it issues two (ADDONLY_FADDS: no add hoisted);
3. checks each kernel against its plain PyTorch version on the card at small
   shapes (weights, outlier, dead components, parent -1, top_k gating with
   exact ties, nearest neighbours with exact ties; for the two redesigned
   kernels also K off the tiling, N = 1 and ragged tiles, an all-dead
   mixture, fewer targets than a chunk, one query, target splits, equal
   targets across chunk, tile and split boundaries, a NaN target row, and
   equal bits on two launches; reg_step against its twin for both solvers
   and every first/last step, and a done scan left as it is; the first
   em_stats body and assign at their edges: K in {1, 3, 8, 16, 32, 63}, N = 1,
   ragged tiles, all-dead rows, zero weights;
   assign on exact inputs with ties and parents -1 and past K bit-equal to
   the plain version, and a NaN logit that never wins; em_step on the partial
   rows of the three em_stats bodies (the first K <= 32, the tiled K >= 33,
   the grouped one) against a float64 run of its twin for every covariance
   type, K in {1, 8, 40, 64, 100, 512} (40 and 100 write floor rows), empty
   components, equal bits on two launches; reg_step on 1, 33 and 528 rows);
4. drives the main path once: hgmm_torch.register_pair with the
   config2_tree_8x3 preset on a 437,645-point pair (the vertex count of the
   Stanford dragon; synthetic trefoil stand-in, ground truth z-rotation
   0.25 rad, t = (0.05, -0.04, 0.06)), with every kernel launch counter set
   to 0 just before and read just after; it fails unless the pose errors are
   within the bounds of tests/test_register.py, every output is finite and
   every kernel of the path was launched;
5. times the tree fit and the registration, and checks and times each kernel
   (its device time a call from a profiler trace, beside CUDA events around
   the calls) against its plain version at the shapes the slice gives it (reg_stats and
   the masked em_stats per K, the launch a scan step or a sweep makes beside
   the standalone call; reg_step on the main path's partials; em_step on
   each level's E-step body's partial rows); then counts
   one register_pair's kernels, copies and memsets (profiler) and host syncs
   (torch's sync debug mode) beside its seconds; then a fit's sweeps
   (sweep_accounting): the flat K = 8 level and a grouped K = 64 level of
   the pair's target under torch's sync debug mode set to "error", one
   em_stats body and one em_step launch a sweep by the counters and two
   kernels a sweep by the profiler; and the tree fit on the card against the same
   fit through the plain versions, by each level's per-point loglik;
6. checks that register_pair on the card agrees with the plain CPU path on a
   4,000-point pair;
7. drives the CLI (hgmm_torch.cli.main) in process, each command with the
   counters set to 0 just before and read just after, on .ply pairs written
   under chiprun_out/smoke/ (removed at the end):
   - `icp --iters 250` on a 437,645-point pair inside ICP's basin: fails
     unless the knn kernel launched, the registration RMSE is below 0.02 and
     the output is finite; then checks the knn kernel against its plain
     version at full size (float64 distances) and times both;
   - `fit-gmm --tree` to an npz, read back with load_tree (levels 8/64/512);
   - `register --preset config3_mahalanobis` on the config-2 pair: fails
     unless the pose meets the bounds and reg_stats launched; then checks
     the K=512 reg_stats with top_k=8 against its plain version at the final
     pose and times it with and without top_k;
   - the odometry path (config 4) on a synthetic KITTI-format loop of 40
     scans of 120,000 points written under chiprun_out/smoke/seq (removed at
     the end). The native reader (hgmm_torch/data/native.py) is built with
     g++ first. Then `odometry` with a checkpoint (dead reckoning),
     `odometry --detect-closures --refine --map` resuming it, then
     `localize` of frame 0 against the map; fails unless em_stats_masked,
     assign and reg_stats launched, both odometry commands read and
     voxelized their scans through the native reader (its calls counted), a
     closure with j - i > 5 was accepted, the refined ATE is
     below the dead-reckoned one, the dead-reckoned ATE is within 1.5x + 0.02
     m of the JAX CLI's on the same sequence, localize recovers frame 0
     within 0.1 m and 1 degree, and every output is finite; then times a
     pair's fit and registration apart, profiles one pair, times refinement
     and the map build, and checks each kernel at the odometry shapes
     against its plain version (strict tolerances; reg_stats, at up to 40 m,
     against float64, its gap to the twin recorded) and against float64,
     with and without zero-weight pads, and times it per K; the profiled pair's
     launches and host syncs are printed as register_pair's are.
8. the bench path: each unit-rate probe (csrc/probes.cu) against its plain
   version (probe_checks, right after the small kernel checks) at K=64/T=256,
   K=512/T=2048 and K=64/T=8192, steps 3 with reps 2 and 6, 1 x 7 (with the
   loops below, every remainder of the bf16 stats kernel's four reps a
   step) and, at the two
   shapes that are timed, the timed loops themselves (steps 1024, reps 2 and
   6; vpu 512 x 512, steps 2048, reps 4 and 8), and the bf16 logits, stats
   and norm with A = 0 (PROBE_ZERO_A_LOOPS), where every rep's eps shows,
   and norm with a seeded standard-normal A at every loop besides; each
   kernel is launched twice for equal bits, and every result is read twice
   and must not change between the reads;
   the two microbenchmarks at the reference's defaults (mxu: K=512/T=2048 and
   K=64/T=8192, steps 1024, reps 2 -> 6; vpu: 512 x 512, steps 2048, reps
   4 -> 8) with the counters at 0 just before; `bench` through the CLI at
   full size (N = 2^21, K = 512, 150 sweeps a chain) with the counters at 0
   just before: fails unless em_stats launched at least 150 times, the JSON
   line holds metric, value, unit and vs_baseline, value is finite and
   positive and vs_baseline <= 1.05; then the sweep's S and loglik against the
   plain version at N = 2^21; then benchmarks/kernel_shapes (five rows, each
   against its bound). A share above 105 % of a bound or a peak fails: it is a
   wrong count, not a fast kernel.
9. the sharded path (hgmm_torch.parallel) on a torch.distributed world of one
   process over NCCL (make_mesh; a card run without NCCL raises) and on
   SHARD_RANKS ranks emulated in one process on the card (EmulatedMesh), after
   pair_accounting: (a) config 5, N = 10,485,760, K = 512, 20 sweeps,
   sharded_em_fit against em_fit from one init (per-sweep loglik within
   FIT_LL_RTOL, parameters within tests/test_parallel.py's tolerances), ms a
   sweep of both, the sharded sweeps under the sync debug mode "error", the
   NCCL kernels a sweep and their device us by the profiler; (b) the config-2
   pair through sharded_tree_fit and sharded_register_tree: the pose bounds,
   register_pair's pose within them, the pair's kernels and host syncs (none
   where register_pair has none); (c) the same through the emulated ranks: the bounds,
   each level's per-point loglik within FIT_LL_RTOL of (b)'s; with the
   odometry sequence, (d) `odometry --sharded` (dead reckoning), resumed with
   --detect-closures --refine --map, and `localize --sharded`, held to the
   bounds of the unsharded commands; (e) refine_chain_sharded on that run's
   chain and closures at world size 1 and on the emulated ranks against the
   dense refine_pose_graph (PG_ATOL). The runs of (a)-(c) are the `shard`
   path of the kernel table (each with the counters at 0, summed).
   Then the native phase: the native reader's KITTI reads and
   voxel_downsample (0.3 m) on every scan of the sequence and its PLY read
   and voxel_downsample on the config-5 cloud (10,485,760 points written as
   a binary PLY, removed after), bit-equal to the numpy paths, both timed.
10. the suites (hgmm_torch/benchmarks), after step 9, each with the counters
   at 0 and each record printed on a line of its own: registration_suite at
   437,645 points (every GMM record within the pose bounds; ICP, 30
   iterations, below the starting pose's RMSE and within the rotation
   bound; knn and every tree kernel launched; then the shapes it newly puts
   on a path, each against its plain version and timed: em_stats K = 64
   unmasked, reg_stats at K = 64 and at the tree's leaves and adaptive cut
   with outlier 0.0); scaling at 262,144 points a rank, K = 64, 20 sweeps on
   the NCCL world of one process (the one-rank sharded fit bit-equal to the
   unsharded one); odometry_suite at its defaults (64 frames, bucket 16,384,
   with e2e; a device-only trace a phase for its device busy time: a
   closure, refined ATE below dead-reckoned in refine and e2e, localize
   within 0.1 m of the refined pose or nearer it than its start, each
   phase's kernels launched), then sharded on 16 frames without e2e
   (localize likewise, the path's kernels launched).
Before the CLI phases, em_stats, em_stats_masked, assign and reg_stats (outlier
-8) are checked against their plain versions at LiDAR scale (coordinates in
+-40 m, a 0.02 m minor axis, 30 % zero-weight rows), and both against float64
statistics of the direct quadratic form; em_step on those statistics against
a float64 run of its twin; the gaps are printed.
Each phase prints one JSON line; the line before the last is the kernel
table (every kernel with its launches on its main path, its time, its plain
version's time, its bound from hgmm_torch.eval.roofline and, for the matrix
probes, torch.matmul's time for the same products in one CUDA graph, the
eager calls' beside it), the last line {"ok": true, "device": ...}. Any failure exits non-zero.
"""

from __future__ import annotations

import contextlib
import hashlib
import io
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

N_POINTS = 437_645
GT_OMEGA = (0.0, 0.0, 0.25)
GT_T = (0.05, -0.04, 0.06)
# tests/test_register.py:45-50
BOUNDS = {"rmse": 0.03, "rot_deg": 3.0, "trans": 0.02, "pose_delta": 0.06}
# Strict tolerances of tests/test_fused_em.py:55-56 (em_stats) and :196-198
# (reg_stats), stated there for N=300 points. S, horn, A and b are sums over
# the N points, so their atol is scaled by N / 300; rtol is kept.
TOL_EM = dict(rtol=2e-3, atol=2e-4, ll_rtol=1e-4)
TOL_REG = dict(horn=(2e-3, 2e-3), A=(2e-3, 2e-2), b=(2e-3, 2e-2), ll_rtol=1e-4)
TIE_GAP = 1e-4  # an assign mismatch is allowed where the top-two logit gap is below this
# ICP's pair: a pose inside its basin; RMSE bound of tests/test_knn_icp.py:43.
ICP_OMEGA = (0.03, -0.05, 0.08)
ICP_T = (0.02, -0.01, 0.03)
ICP_RMSE = 0.02
# The cloud is a dense volume (a Gaussian tube), so every nearest neighbour
# lies within the point spacing (~0.008) and a point-to-point step moves the
# source ~1 % of the way: on the H100 the registration RMSE falls from 0.073
# to 0.061 in 25 iterations and snaps to the exact matches after ~190.
ICP_ITERS = 250
# The kernels each path must launch (each path runs with the counters at 0).
TREE_PATH = ("em_stats", "em_stats_masked", "em_step", "assign", "reg_stats", "reg_step")
PROBES = ("probe_logits", "probe_addonly", "probe_stats", "probe_norm", "probe_vpu")
PATH_KERNELS = {"register_pair": TREE_PATH, "cli_icp": ("knn",), "cli_register_config3": TREE_PATH,
                "cli_odometry": TREE_PATH, "cli_odometry_closures": TREE_PATH,
                "cli_localize": ("reg_stats", "reg_step"), "cli_bench": ("em_stats",), "probes": PROBES,
                "shard": TREE_PATH, "cli_odometry_sharded": TREE_PATH,
                "cli_odometry_closures_sharded": TREE_PATH,
                "cli_localize_sharded": ("reg_stats", "reg_step"),
                "registration_suite": TREE_PATH + ("knn",), "odometry_suite": TREE_PATH,
                "odometry_suite_sharded": TREE_PATH, "scaling": ("em_stats", "em_step")}
SOURCES = {"em_stats": "em_stats.cu", "em_stats_masked": "em_stats.cu", "em_step": "em_step.cu",
           "assign": "assign.cu",
           "reg_stats": "reg_stats.cu", "reg_step": "reg_step.cu", "knn": "knn.cu",
           **{name: "probes.cu" for name in PROBES}}
REPLACES = {"em_stats": "hgmm/ops/fused_em.py:559", "em_stats_masked": "hgmm/ops/fused_em.py:559",
            "assign": "hgmm/ops/fused_em.py:859", "reg_stats": "hgmm/ops/fused_em.py:920",
            # no TPU kernel: the XLA ops of the reference's scan steps
            "reg_step": "hgmm/pipelines/register.py:80", "em_step": "hgmm/models/gmm.py:121",
            "knn": "hgmm/ops/knn.py:60", "probe_logits": "benchmarks/mxu_microbench.py:54",
            "probe_addonly": "benchmarks/mxu_microbench.py:73",
            "probe_stats": "benchmarks/mxu_microbench.py:86",
            "probe_norm": "benchmarks/mxu_microbench.py:106",
            "probe_vpu": "benchmarks/vpu_microbench.py:52"}
# The path a kernel's `launches` are read from, where it is not register_pair.
MAIN_PATH = {"knn": "cli_icp", **{name: "probes" for name in PROBES}}
# The bench path. Probe checks: bfloat16 operands carry identical bits in the
# kernel and its plain version and only the float32 sum order differs; float32
# operands likewise. atol is a share of the largest |reference| (a sum of
# products of both signs can land near zero).
PROBE_CHECK_SHAPES = ((64, 256), (512, 2048), (64, 8192))
PROBE_CHECK_LOOPS = ((3, 2), (3, 6), (1, 7))  # steps, reps; the timed loops are checked besides
# bf16 logits, stats and norm with A = 0 (wt, phi32, ones): the result is
# steps * sum of eps_r times B's column sums, so a kernel that drops, repeats
# or hoists a rep's eps shows (with normal operands bf16(x + 1e-6) = x almost
# everywhere).
PROBE_ZERO_A_LOOPS = ((1, 1), (3, 6), (2, 64))
PROBE_TOL = {"bf16": (2e-3, 1e-4), "f32": (1e-5, 1e-5)}  # rtol, atol / max|ref|
# float32 adds that one accumulator makes a product (csrc/probes.cu): the
# float32 stats kernel accumulates by FMA over its block's T slice (ST = 32),
# every other kernel adds one finished product. At the timed loops the check
# allows 2^-24 for each add of that chain, beside PROBE_TOL.
PROBE_CHAIN = {"stats_f32": 32}
SENTINEL = 0x5A5A5A5A
MXU_SHAPES = ((512, 2048), (64, 8192))  # the reference's defaults; K=64 needs T >= 8192
MXU_LOOP = dict(steps=1024, r1=2, r2=6)
VPU_LOOP = dict(k=512, t=512, steps=2048, r1=4, r2=8)
MAX_SHARE = 1.05  # of a bound or a peak
# The times of the redesigned kernels before their redesign, at the same
# shapes (PERF.md section 6; em_stats K = 8 and assign from the profiler's
# trace). Constants, not readings of this run: they are printed on a line of
# their own and never in the `kernels` line.
MS_BEFORE_REDESIGN = {"knn_437645x437645": 69.6, "em_stats_k512_n2097152": 4.04,
                      "em_stats_k8_n437645": 0.022, "em_stats_k8_n16384": 0.0046,
                      "assign_k8_n437645": 0.005, "assign_k64_masked_n437645": 0.022,
                      "assign_k512_masked_n437645": 0.041, "assign_n16384": 0.003}
# Kernels and host syncs a pair (PERF.md section 5): an odometry pair before
# the registration scan stayed on the card, and both pairs before the fit's
# sweeps did. Constants, as above.
PAIR_BEFORE = {"odometry_pair_kernels_before_scan_on_card": 29_493,
               "odometry_pair_host_syncs_before_scan_on_card": 179,
               "odometry_pair_kernels_before_sweeps_on_card": 6_781,
               "odometry_pair_host_syncs_before_sweeps_on_card": 8,
               "register_pair_kernels_before_sweeps_on_card": 8_047,
               "register_pair_host_syncs_before_sweeps_on_card": 10}
BEFORE_NOTE = "constants recorded on an NVIDIA H100 80GB HBM3, 700.00 W; not measured in this run"
# Kernels whose -Xptxas -v report the build line prints; a spill fails the run.
REPORTED_KERNELS = ("em_stats_tiled_kernel", "knn_kernel", "reg_stats_lanes_kernel",
                    "reg_stats_top_k_kernel", "reg_step_kernel", "em_stats_grouped_kernel",
                    "em_stats_kernel", "assign_all_kernel", "assign_masked_kernel", "em_step_kernel",
                    "probe_logits_bf16_kernel", "probe_stats_bf16_kernel", "probe_norm_bf16_kernel",
                    "probe_addonly_kernel")
# Kernels on the warpgroup tensor cores: each instantiation's SASS must hold
# HGMMA (wgmma) and no HMMA (mma.sync), ptxas must not have serialized its
# wgmma, and it keeps no stack frame. The build line prints the tensor-core
# instructions of every probe.
WGMMA_KERNELS = ("probe_logits_bf16_kernel", "probe_stats_bf16_kernel", "probe_norm_bf16_kernel")
# em_step against its plain twin (float32, the order of ops/gaussians.py):
# T2 / T0 - mu mu^T cancels in float32, so the kernel (float64 inside, float32
# out) is held to a float64 run of the twin on the same statistics, within
# EM_STEP_RTOL of each value plus EM_STEP_ATOL of the largest (a few float32
# roundings of the cast; the table's entries near 0 are sums of terms of the
# row's size, so a row's largest entry sets its atol); the float32 twin's own
# gap to that run is printed beside it.
EM_STEP_RTOL = 1e-6
EM_STEP_ATOL = 1e-6
# The tree fit on the card against the same fit through the plain versions
# (float32 M-step, another sum order, argmax near-ties that move a point to
# another parent): each level's per-point loglik within this relative gap, the
# tolerance tests/test_torch_models.py holds the two packages' trees to.
FIT_LL_RTOL = 1e-3
# A fit's sweep on the card: em_stats' body, then em_step, which sums the
# body's partial rows (em_stats' reduce kernel is not on the fit path).
SWEEP_KERNELS = 2
# The sharded phase: config 5 at benchmarks/large_n.py's size (N, K, sweeps);
# the emulated ranks of the multi-rank runs on one card; refine_chain_sharded
# against the dense solver (tests/test_pose_graph.py's sharded-vs-dense atol,
# 10 Gauss-Newton steps as refine_odometry takes).
SHARD_N = 10 * (1 << 20)
SHARD_K = 512
SHARD_SWEEPS = 20
SHARD_RANKS = 4
PG_ITERS = 10
PG_ATOL = 1e-3


# The odometry phase (config 4 through the CLI) and the LiDAR-scale checks.
ODO_BUCKET = 16_384  # the CLI's --bucket default
LIDAR_EXTENT = 40.0  # metres: coordinates of the LiDAR-scale kernel checks
# Where the kernels also meet the strict tolerances against their twins: at
# 40 m a 0.02 m minor axis makes the expanded quadratic form's terms ~1e6
# (float32 rounds them at ~0.1 nat), and on an H100 one or two entries of
# reg_stats' horn, A or b miss TOL_REG by 0.2-0.9 % at 40, 20, 10 and 5 m;
# at 2 m and 1 m every kernel passes (ROADMAP Queue 3).
LIDAR_STRICT_EXTENT = 2.0
# At metric scale the kernel's gap to the float64 direct form may be this
# many times its twin's (plus the strict atol).
F64_FACTOR = 2.0
# An assign mismatch at LiDAR scale is a near-tie when the logit gap is below
# TIE_GAP + this share of the sum of the magnitudes of its terms (~1e6 at
# 40 m with a 0.02 m minor axis, where float32 rounds at ~0.1).
LIDAR_TIE_REL = 2e-6
# Dead-reckoned ATE (m) that the JAX package's CLI prints for this sequence,
# run on the CPU: python -m hgmm.cli.main --platform cpu odometry SEQ --poses
# SEQ/poses.txt (PERF.md, section 4; the sequence it read had the md5 sums in
# SEQ_MD5, and the phase fails on any other). The port's must be within 1.5x
# of it + 0.02 m: the two packages draw their inits differently, so the
# chains are different runs.
JAX_CLI_DEAD_ATE = 0.1593
SEQ_MD5 = {"poses.txt": "4bfebd3c0a469f5b6e1f8c11ce6b66c0",
           "velodyne/000000.bin": "51d8b94212a0490bd47bc5f971794fb6"}
ODO_ATE_FACTOR = 1.5
ODO_ATE_SLACK = 0.02
LOC_TRANS = 0.1  # metres: localize frame 0 against the map
LOC_DEG = 1.0

# The suites (hgmm_torch/benchmarks/{registration_suite,odometry_suite,
# scaling}.py) and the native reader (hgmm_torch/data/native.py).
NATIVE_VOXEL = 0.3  # metres: the CLI's --voxel default
# odometry_suite at its defaults, then sharded over the smoke's NCCL mesh on
# fewer frames; the kernels each phase must launch.
ODO_SUITE = dict(frames=64, bucket=16_384)
ODO_SUITE_SHARDED = dict(frames=16, bucket=16_384, skip_e2e=True)
FIT_KERNELS = ("em_stats", "em_stats_masked", "em_step", "assign")
ODO_PHASE_KERNELS = {"fit": FIT_KERNELS, "register": ("reg_stats", "reg_step"), "closures": TREE_PATH,
                     "map_build": FIT_KERNELS, "localize": ("reg_stats", "reg_step"), "e2e": TREE_PATH}
# odometry_suite's localize must land within this of the refined pose or
# nearer it than its dead-reckoned start (a chain without closures starts on
# the refined pose). The reference's 0.10 m (RESULTS.md section 6c) was one
# init draw: on the 64-frame sequence from one numpy init on the CPU the JAX
# package lands 0.1028 m off (from 0.188) and the port 0.0891 m (tests/
# test_torch_suites.py, the slow full-size case); the port's own draw on an
# H100 0.117 m (from 0.147). The distance is printed beside this target.
LOC_SUITE_TARGET = 0.1  # metres
# scaling at the reference's defaults: points a rank, K, sweeps.
SCALING = dict(points_per_device=262_144, k=64, iters=20)


def log(obj) -> None:
    print(json.dumps(obj), flush=True)


# --------------------------------------------------------------------------
# the synthetic KITTI-format LiDAR sequence of the odometry phase

SEQ_FRAMES = 40
SEQ_POINTS = 120_000  # an HDL-64E scan in KITTI's .bin files
SEQ_SEED = 7
SEQ_STEP = 1.0  # metres between frames, around one closed loop
SEQ_RANGE = 40.0  # metres kept around the sensor
SEQ_FOV = 1.6  # rad either side of the heading (a forward sector: the drift source)
SEQ_NOISE = 0.01  # metres
# Tr (velo -> cam0) of tests/fixtures/make_kitti_mini.py: the KITTI axis
# permutation and a small lever arm.
SEQ_TR_R = ((0.0, -1.0, 0.0), (0.0, 0.0, -1.0), (1.0, 0.0, 0.0))
SEQ_TR_T = (0.01, -0.05, -0.27)


def lidar_world(rng, n: int):
    """A ~60 m x 60 m scene built like tests/fixtures/make_kitti_mini.py:
    ground at -1.7 m, two facades (y = 25 pins y and yaw, x = -25 pins x),
    30 boxes with two faces each and 16 pillars, [n, 3] float64. The boxes
    and pillars constrain the stretch of the loop that faces neither facade
    (with 14 boxes and 10 pillars, two of its pairs fell into wrong minima
    for some init draws, in both packages). Four facades constrain every
    pair instead, but then `localize` of a forward-sector scan against the
    whole-block map drifts off, in both packages (ROADMAP Queue 3)."""
    import numpy as np

    def u(lo, hi, m):
        return rng.uniform(lo, hi, m)

    m = n // 3
    chunks = [np.stack([u(-30, 30, m), u(-30, 30, m), rng.normal(0, 0.02, m) - 1.7], 1)]
    m = n // 8
    chunks.append(np.stack([u(-30, 30, m), 25.0 + rng.normal(0, 0.02, m), u(-1.7, 6.0, m)], 1))
    chunks.append(np.stack([-25.0 + rng.normal(0, 0.02, m), u(-30, 30, m), u(-1.7, 6.0, m)], 1))
    n_box, n_pillar = 30, 16
    per = (n - sum(len(c) for c in chunks)) // (2 * n_box + n_pillar)
    centers = rng.uniform(-22, 22, (n_box + n_pillar, 2))
    for cx, cy in centers[:n_box]:
        hx, hy, h = u(1.0, 2.5, 1)[0], u(1.0, 2.5, 1)[0], u(1.0, 3.5, 1)[0]
        sx, sy = rng.choice([-1.0, 1.0], 2)
        chunks.append(np.stack([np.full(per, cx + sx * hx), cy + u(-hy, hy, per),
                                u(-1.7, -1.7 + h, per)], 1))
        chunks.append(np.stack([cx + u(-hx, hx, per), np.full(per, cy + sy * hy),
                                u(-1.7, -1.7 + h, per)], 1))
    for cx, cy in centers[n_box:]:
        a = u(0, 2 * np.pi, per)
        chunks.append(np.stack([cx + 0.3 * np.cos(a), cy + 0.3 * np.sin(a), u(-1.7, 4.0, per)], 1))
    return np.concatenate(chunks)


def write_lidar_sequence(root: Path, n_frames: int = SEQ_FRAMES, n_points: int = SEQ_POINTS,
                         seed: int = SEQ_SEED) -> None:
    """Write a KITTI-format sequence (velodyne/*.bin, poses.txt, calib.txt)
    to root: the sensor drives one closed loop of SEQ_STEP steps around the
    middle of lidar_world, heading along the loop; each scan is the world in
    the sensor frame within SEQ_RANGE and +-SEQ_FOV of the heading, a random
    n_points of it, plus SEQ_NOISE of Gaussian noise. numpy only, from seed."""
    import numpy as np

    rng = np.random.default_rng(seed)
    world = lidar_world(rng, 400_000)
    radius = n_frames * SEQ_STEP / (2 * np.pi)

    def yaw(a):
        c, s = np.cos(a), np.sin(a)
        return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])

    velo = root / "velodyne"
    velo.mkdir(parents=True, exist_ok=True)
    T_w_velo = []
    for k in range(n_frames):
        th = 2 * np.pi * k / n_frames
        R, t = yaw(th + np.pi / 2), np.array([radius * np.cos(th), radius * np.sin(th), 0.0])
        T_w_velo.append((R, t))
        local = (world - t) @ R
        keep = ((np.linalg.norm(local[:, :2], axis=1) < SEQ_RANGE)
                & (np.abs(np.arctan2(local[:, 1], local[:, 0])) < SEQ_FOV))
        local = local[keep]
        if local.shape[0] > n_points:
            local = local[rng.choice(local.shape[0], n_points, replace=False)]
        local = local + rng.normal(0.0, SEQ_NOISE, local.shape)
        refl = rng.uniform(0.0, 1.0, (local.shape[0], 1))
        np.concatenate([local, refl], 1).astype("<f4").tofile(velo / f"{k:06d}.bin")

    # poses.txt: P_k = T_{cam0 <- cam_k} with T_w_cam_k = T_w_velo_k o Tr^-1.
    R_tr, t_tr = np.array(SEQ_TR_R), np.array(SEQ_TR_T)

    def compose(a, b):
        return a[0] @ b[0], a[0] @ b[1] + a[1]

    def inverse(a):
        return a[0].T, -(a[0].T @ a[1])

    T_w_cam = [compose(T, inverse((R_tr, t_tr))) for T in T_w_velo]
    cam0_inv = inverse(T_w_cam[0])
    rows = []
    for T in T_w_cam:
        R, t = compose(cam0_inv, T)
        rows.append(" ".join(f"{v:.9e}" for v in np.hstack([R, t[:, None]]).ravel()))
    (root / "poses.txt").write_text("\n".join(rows) + "\n")
    dummy = " ".join(["0.0"] * 12)
    tr = " ".join(f"{v:.9e}" for v in np.hstack([R_tr, t_tr[:, None]]).ravel())
    (root / "calib.txt").write_text(
        f"P0: {dummy}\nP1: {dummy}\nP2: {dummy}\nP3: {dummy}\nTr: {tr}\n")


class CheckFailed(AssertionError):
    pass


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    repo = Path(__file__).resolve().parent
    if not (repo / "hgmm_torch" / "__init__.py").is_file():
        print(f"chip_smoke: no hgmm_torch package beside {__file__}", file=sys.stderr)
        return 1
    sys.path.insert(0, str(repo))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)

    import hgmm_torch
    from hgmm_torch.ops import _build, fused_em

    if Path(hgmm_torch.__file__).resolve().parent != repo / "hgmm_torch":
        raise CheckFailed(f"imported hgmm_torch from {hgmm_torch.__file__}, not from {repo}")
    dev = torch.device("cuda")

    prebuilt = _build.library_path().exists()
    t0 = time.perf_counter()
    _build.load()
    build_s = time.perf_counter() - t0
    report = {name: rep for key in REPORTED_KERNELS for name, rep in _build.kernel_report(key).items()}
    tensor_ops = _build.sass_report("probe_")
    from hgmm_torch.ops import probes

    vpu_steps = {name: probes.vpu_sass_counts(loops)
                 for name, loops in _build.sass_loops("probe_vpu_kernel").items()}
    add_reps = {name: probes.addonly_sass_counts(loops)
                for name, loops in _build.sass_loops("probe_addonly_kernel").items()}
    log({"phase": "build", "seconds": build_s, "library": _build.library_path().name,
         "compiled_here": not prebuilt, "ptxas": report, "tensor_ops": tensor_ops,
         "vpu_step_instructions": vpu_steps, "addonly_rep_instructions": add_reps})
    spilled = {name: rep for name, rep in report.items()
               if rep.get("spill_store_bytes") or rep.get("spill_load_bytes") or "registers" not in rep}
    if spilled or not all(any(key in name for name in report) for key in REPORTED_KERNELS):
        raise CheckFailed(f"build: a kernel spills registers or is missing from the ptxas log: "
                          f"{spilled or sorted(report)}")
    wg = {name: ops for name, ops in tensor_ops.items() if any(key in name for key in WGMMA_KERNELS)}
    not_wgmma = {name: {**ops, **report.get(name, {})} for name, ops in wg.items()
                 if ops["HGMMA"] == 0 or ops["HMMA"] or report.get(name, {}).get("wgmma_serialized")
                 or report.get(name, {}).get("stack_bytes")}
    if not_wgmma or not all(any(key in name for name in wg) for key in WGMMA_KERNELS):
        raise CheckFailed(f"build: a wgmma kernel holds no HGMMA, holds HMMA, has its wgmma "
                          f"serialized, keeps a stack frame (a register array indexed at run "
                          f"time) or is missing from the SASS: {not_wgmma or sorted(wg)}")

    # exp2 bodies (ILb1E): a MUFU.EX2 a step, at most VPU_CONVERTS packed
    # converts; no body converts on the quarter-rate F2F (a body without a
    # loop that converts has no convert_f2f count and fails too).
    bad_vpu = {name: c for name, c in vpu_steps.items()
               if c.get("convert_f2f", 1.0) > 0.0
               or ("ILb1E" in name and (c["exp2"] < 1.0
                                        or c["convert_f2fp"] + c["convert_f2f"] > probes.VPU_CONVERTS))}
    modes = {mode for mode in ("ILb1E", "ILb0E") if any(mode in name for name in vpu_steps)}
    if bad_vpu or len(modes) < 2:
        raise CheckFailed(f"build: a probe_vpu body converts on F2F, issues no MUFU.EX2 a step, more "
                          f"conversions a step than the design's {probes.VPU_CONVERTS}, or is missing "
                          f"from the SASS: {bad_vpu or sorted(vpu_steps)}")
    bad_add = {name: c for name, c in add_reps.items()
               if c.get("fadd_per_element_rep") != probes.ADDONLY_FADDS}
    if bad_add or len(add_reps) != 1:
        raise CheckFailed(f"build: a probe_addonly body issues other than {probes.ADDONLY_FADDS} adds an "
                          f"element and rep in its busiest loop (one hoisted), or is missing from the "
                          f"SASS: {bad_add or sorted(add_reps)}")

    errs = {name: 0.0 for name in fused_em.LAUNCHES}
    small_checks(torch, dev, errs)
    log({"phase": "kernel_checks_small", "ok": True})
    t0 = time.perf_counter()
    report = probe_checks(torch, dev, errs)
    log({"phase": "probe_checks", "seconds": time.perf_counter() - t0, **report})
    if sys.argv[1:] == ["--probe-checks"]:
        return 0
    from hgmm_torch.parallel import make_mesh

    mesh = make_mesh(dev)  # NCCL, a world of one process; raises without NCCL
    try:
        return run_paths(torch, dev, repo, mesh, errs)
    finally:
        torch.distributed.destroy_process_group()


def run_paths(torch, dev, repo, mesh, errs) -> int:
    """Steps 4-9 (see the module docstring) and the kernel table."""
    from hgmm_torch.ops import fused_em

    work = repo / "chiprun_out" / "smoke"
    work.mkdir(parents=True, exist_ok=True)
    if sys.argv[1:] == ["--sharded-only"]:
        pair = pair_accounting(torch, dev, work)
        log({"phase": "pair_accounting", **pair})
        shard, _ = sharded_phase(torch, dev, mesh, work, pair)
        log({"phase": "sharded", **shard})
        try:
            write_lidar_sequence(work / "seq")
            shard_cli, _ = sharded_cli(torch, dev, mesh, work, work / "seq")
        finally:
            shutil.rmtree(work / "seq", ignore_errors=True)
        log({"phase": "sharded_cli", **shard_cli})
        return 0
    if sys.argv[1:] == ["--suites-only"]:
        run_suites(torch, dev, work, errs, {name: [] for name in fused_em.LAUNCHES})
        try:
            write_lidar_sequence(work / "seq")
            log({"phase": "native", **native_phase(torch, work, work / "seq")})
        finally:
            shutil.rmtree(work / "seq", ignore_errors=True)
        return 0

    counts, main_res = main_path(torch, dev)
    log({"phase": "main_path", **main_res, "launches": counts})

    timings = slice_checks(torch, dev, errs)
    pair = pair_accounting(torch, dev, work)
    log({"phase": "pair_accounting", **pair})
    log({"phase": "sweep_accounting", **sweep_accounting(torch, dev, work)})
    shard, shard_counts = sharded_phase(torch, dev, mesh, work, pair)
    log({"phase": "sharded", **shard})
    agreement = cpu_agreement(torch, dev)
    log({"phase": "cpu_agreement", **agreement})

    probe_counts = probes_phase(torch, dev, timings)
    bench_counts = cli_bench(torch, dev, errs, timings)
    kernel_shapes_phase(dev)

    metric_errs = {}
    log({"phase": "kernel_checks_lidar", "extents_m": [LIDAR_EXTENT, LIDAR_STRICT_EXTENT],
         "n": ODO_BUCKET, "gaps": lidar_checks(torch, dev, errs, metric_errs)})

    try:
        icp_counts = cli_icp(torch, dev, work, errs, timings)
        cli_fit_tree(torch, work)
        c3_counts = cli_register_config3(torch, dev, work, errs, timings)
        odo_counts = cli_odometry(torch, dev, work, errs, metric_errs, timings)
        shard_cli, shard_cli_counts = sharded_cli(torch, dev, mesh, work, work / "seq")
        log({"phase": "sharded_cli", **shard_cli})
        # Last: a pair's profiled torch kernels depend on what ran before in
        # the process (the odometry pair's 1,276 read 1,275 with the native
        # phase's host work ahead of it, 1,274 with the suites too), so these
        # run after every phase whose counts earlier runs recorded.
        log({"phase": "native", **native_phase(torch, work, work / "seq")})
        suite_counts = run_suites(torch, dev, work, errs, timings)
    finally:
        for f in work.glob("*.ply"):
            f.unlink()
        shutil.rmtree(work / "seq", ignore_errors=True)
    launches = {"register_pair": counts, "cli_icp": icp_counts, "cli_register_config3": c3_counts,
                **odo_counts, "cli_bench": bench_counts, "probes": probe_counts, "shard": shard_counts,
                **shard_cli_counts, **suite_counts}

    kernels = []
    for name in fused_em.LAUNCHES:
        for entry in timings[name]:
            add_bound(name, entry)
        head = next(t for t in timings[name] if t.get("headline"))
        path = MAIN_PATH.get(name, "register_pair")
        kernels.append({
            "name": name, "route": "cuda", "source": f"hgmm_torch/csrc/{SOURCES[name]}",
            "replaces": REPLACES[name], "launches": launches[path][name],
            "max_abs_err": errs[name], "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head.get("library_ms"),
            "max_abs_err_metric_scale": metric_errs.get(name),
            "main_path": path, "launches_by_path": {p: c[name] for p, c in launches.items()},
            "shapes": timings[name],
        })
    log({"ms_before_redesign": MS_BEFORE_REDESIGN, **PAIR_BEFORE, "note": BEFORE_NOTE})
    log({"kernels": kernels})
    log({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})
    return 0


# --------------------------------------------------------------------------
# helpers


def run_suites(torch, dev, work, errs, timings) -> dict:
    """Step 10: the three suites, each with the counters at 0; returns their
    launches by path."""
    counts = {}
    counts["registration_suite"], rec = registration_suite_phase(torch, dev, errs, timings)
    log({"phase": "registration_suite", **rec})
    counts["scaling"], rec = scaling_phase(torch, dev)
    log({"phase": "scaling", **rec})
    odo_counts, rec = odometry_suite_phase(torch, dev, work)
    log({"phase": "odometry_suite", **rec})
    return {**counts, **odo_counts}


def cuda_ms(torch, fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() over `reps` launches, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(torch, fn, reps: int = 20) -> float:
    """kernel_compare.device_us in ms, its trace under chiprun_out/smoke."""
    from hgmm_torch.benchmarks.kernel_compare import device_us

    d = Path(__file__).resolve().parent / "chiprun_out" / "smoke"
    d.mkdir(parents=True, exist_ok=True)
    return device_us(fn, reps, where=d)[0] / 1e3


def close(torch, name: str, got, ref, rtol: float, atol: float) -> float:
    """Raise unless |got - ref| <= atol + rtol |ref| everywhere; return max |got - ref|."""
    got = got.double().cpu()
    ref = ref.double().cpu()
    if not bool(torch.isfinite(got).all()):
        raise CheckFailed(f"{name}: non-finite kernel output")
    err = (got - ref).abs()
    bad = err > atol + rtol * ref.abs()
    if bool(bad.any()):
        i = int(torch.argmax((err - atol - rtol * ref.abs()).flatten()))
        raise CheckFailed(
            f"{name}: {int(bad.sum())} entries out of tolerance (rtol {rtol}, atol {atol}); "
            f"worst got {got.flatten()[i].item()} ref {ref.flatten()[i].item()}"
        )
    return float(err.max()) if err.numel() else 0.0


def check_em(torch, name, got, ref, n, errs):
    scale = n / 300.0
    e1 = close(torch, f"{name}.S", got.S, ref.S, TOL_EM["rtol"], TOL_EM["atol"] * scale)
    e2 = close(torch, f"{name}.loglik", got.loglik, ref.loglik, TOL_EM["ll_rtol"], 0.0)
    errs[name] = max(errs[name], e1, e2)


def check_reg(torch, got, ref, n, errs):
    """n: the point count of the sums (the points of weight > 0)."""
    scale = n / 300.0
    e = [close(torch, f"reg_stats.{f}", getattr(got, f), getattr(ref, f), r, a * scale)
         for f, (r, a) in ((f, TOL_REG[f]) for f in ("horn", "A", "b"))]
    e.append(close(torch, "reg_stats.loglik", got.loglik, ref.loglik, TOL_REG["ll_rtol"], 0.0))
    errs["reg_stats"] = max(errs["reg_stats"], *e)


def check_assign(torch, got, ref, points, W, parent, branch, errs, rel=0.0):
    """Equal, except where the kernel's choice is within TIE_GAP (plus `rel`
    times the sum of the magnitudes of the logit's terms, |psi| . |W| / 2) of
    the plain version's best logit: a near-tie that float32 summation order
    can flip. Records the largest such logit gap as the kernel's error."""
    from hgmm_torch.ops import em_ref
    from hgmm_torch.ops.gaussians import features

    mism = (got != ref).nonzero().flatten()
    gap = 0.0
    if mism.numel():
        logits = em_ref._logits(points[mism], W)
        if parent is not None:
            logits = em_ref.child_mask_logits(logits, parent[mism], branch)
        rows = torch.arange(mism.numel(), device=logits.device)
        gaps = logits[rows, ref[mism].long()] - logits[rows, got[mism].long()]
        limit = TIE_GAP + rel * 0.5 * (features(points[mism]).abs() @ W[:10].abs()).amax(1)
        gap = float(gaps.max())
        if not bool((gaps < limit).all()):
            raise CheckFailed(f"assign: {int((gaps >= limit).sum())} of {mism.numel()} "
                              f"mismatches are not near-ties (largest gap {gap})")
    errs["assign"] = max(errs["assign"], gap)


def check_reg_top_k(torch, pts, w, W, mu, A6, b3, pose, top_k, outlier, errs, max_share=0.01):
    """reg_stats with top_k gating against em_ref. Points whose gate float32
    rounding decides (em_ref.top_k_near_ties, required below max_share) weigh
    0 in both: there one version may keep a component the other gates out."""
    from hgmm_torch.ops import em_ref, fused_em, prepare

    near = em_ref.top_k_near_ties(pts, W, pose, top_k)
    share = float(near.double().mean())
    if not share < max_share:
        raise CheckFailed(f"reg_stats top_k={top_k}: {share:.4f} of the points are near-ties")
    w = (torch.ones_like(pts[:, 0]) if w is None else w) * (~near)
    got = fused_em.reg_stats(prepare(pts, w).pts4, W, mu, A6, b3, pose, top_k, outlier)
    ref = em_ref.reg_stats(pts, W, mu, A6, b3, pose, w, top_k, outlier)
    check_reg(torch, got, ref, int((w > 0).sum()), errs)
    return share


def check_knn(torch, q, t, idx, d2, ref_idx, ref_d2, errs, min_agree=None):
    """The kernel's neighbour is no farther than the twin's, by float64
    distances (+ 1e-6 (1 + |q|^2)); its d2 is the float32 distance to it.
    Returns the share of equal indices."""
    q64, t64 = q.double(), t.double()
    mine = ((q64 - t64[idx.long()]) ** 2).sum(1)
    theirs = ((q64 - t64[ref_idx.long()]) ** 2).sum(1)
    excess = mine - theirs - 1e-6 * (1.0 + (q64 ** 2).sum(1))
    if not bool((excess <= 0).all()):
        raise CheckFailed(f"knn: {int((excess > 0).sum())} queries got a farther neighbour "
                          f"than the plain version (worst by {float(excess.max())})")
    close(torch, "knn.d2", d2, mine, 1e-5, 1e-7)
    errs["knn"] = max(errs["knn"], float((d2.double() - ref_d2.double()).abs().max()))
    agree = float((idx == ref_idx).double().mean())
    if min_agree is not None and not agree >= min_agree:
        raise CheckFailed(f"knn: indices agree on {agree:.4f} < {min_agree}")
    return agree


def random_mixture(torch, k, gen, dev, dead=()):
    from hgmm_torch.ops.gaussians import MixtureParams

    mu = torch.randn(k, 3, generator=gen)
    a = 0.3 * torch.randn(k, 3, 3, generator=gen)
    sigma = a @ a.transpose(1, 2) + 0.05 * torch.eye(3)
    pi = torch.softmax(torch.randn(k, generator=gen), 0)
    for j in dead:
        pi[j] = 0.0
    pi = pi / pi.sum()
    return MixtureParams(pi.to(dev), mu.to(dev), sigma.to(dev))


# --------------------------------------------------------------------------
# phases


def small_checks(torch, dev, errs) -> None:
    """Each kernel against its plain version on small random inputs."""
    from hgmm_torch.ops import em_ref, fused_em, prepare
    from hgmm_torch.ops.gaussians import pack_loglik_weights, precision_terms, sym_pack
    from hgmm_torch.models.se3 import so3_exp

    gen = torch.Generator().manual_seed(0)
    n = 3000
    pts = torch.randn(n, 3, generator=gen).to(dev)
    w = torch.rand(n, generator=gen).to(dev)
    for k in (8, 64, 512):
        params = random_mixture(torch, k, gen, dev, dead=(3,))
        W = pack_loglik_weights(params)
        for weights, outlier in ((None, None), (w, -3.0)):
            prep = prepare(pts, weights)
            got = fused_em.em_stats(prep.pts4, W, outlier)
            ref = em_ref.em_stats(pts, W, weights, outlier)
            check_em(torch, "em_stats", got, ref, n, errs)
        parent = torch.randint(-1, k // 8, (n,), generator=gen).to(dev)
        prep = prepare(pts, w)
        check_em(torch, "em_stats_masked", fused_em.em_stats_masked(prep.pts4, W, parent, 8),
                 em_ref.em_stats_masked(pts, W, parent, 8, w), n, errs)
        check_assign(torch, fused_em.assign(prep.pts4, W), em_ref.assign(pts, W), pts, W,
                     None, None, errs)
        check_assign(torch, fused_em.assign(prep.pts4, W, parent, 8),
                     em_ref.assign(pts, W, parent, 8), pts, W, parent, 8, errs)
        A, b, _ = precision_terms(params)
        pose = (so3_exp(torch.tensor([0.1, -0.2, 0.3], device=dev)),
                torch.tensor([0.05, 0.0, -0.1], device=dev))
        for weights, outlier in ((None, None), (w, -2.0)):
            prep = prepare(pts, weights)
            got = fused_em.reg_stats(prep.pts4, W, params.mu, sym_pack(A), b, pose, None, outlier)
            ref = em_ref.reg_stats(pts, W, params.mu, sym_pack(A), b, pose, weights, None, outlier)
            check_reg(torch, got, ref, n, errs)
        # top_k gating (K itself gates nothing), on this mixture with a dead
        # component and on one with every component twice (exact ties).
        half = random_mixture(torch, k // 2, gen, dev, dead=(1,))
        twice = type(half)(torch.cat([half.pi, half.pi]) / 2, torch.cat([half.mu, half.mu]),
                           torch.cat([half.sigma, half.sigma]))
        for mix in (params, twice):
            A2, b2, _ = precision_terms(mix)
            W2 = pack_loglik_weights(mix)
            for top_k in (1, 8, 32, k):
                for weights, outlier in ((None, None), (w, 0.0)):
                    check_reg_top_k(torch, pts, weights, W2, mix.mu, sym_pack(A2), b2, pose,
                                    top_k, outlier, errs)
    # Nearest neighbours, with a copy of the target twice (exact ties) and
    # queries that sit on targets.
    from hgmm_torch.ops import knn

    for nq, nt in ((500, 700), (3000, 5000)):
        q = torch.randn(nq, 3, generator=gen)
        t = torch.randn(nt, 3, generator=gen)
        for tt in (t, torch.cat([t, t])):
            qq = q.clone()
            qq[: nq // 4] = tt[: nq // 4]
            qq, tt = qq.to(dev), tt.to(dev)
            idx, d2 = knn.nearest_neighbor_cuda(qq, tt)
            ref_idx, ref_d2 = knn.nearest_neighbor_ref(qq, tt)
            check_knn(torch, qq, tt, idx, d2, ref_idx, ref_d2, errs, min_agree=0.98)
            if tt.shape[0] == 2 * nt and not int(idx.max()) < nt:
                raise CheckFailed("knn: an exact tie went to the higher index")
    new_kernel_edges(torch, dev, gen, errs)
    reg_step_checks(torch, dev, gen, errs)
    # em_step on the partial rows of the three bodies: the first (K <= 32) or
    # the tiled one (K >= 33) unmasked, and the grouped one under a parent
    # mask; K = 40 and 100 write the table's floor rows (64 and 128 rows).
    for k in (1, 8, 40, 64, 100, 512):
        params = random_mixture(torch, k, gen, dev, dead=(0,))
        pts = torch.randn(20_000, 3, generator=gen).to(dev)
        w = torch.rand(20_000, generator=gen).to(dev)
        w[::4] = 0.0
        p4 = prepare(pts, w).pts4
        W = pack_loglik_weights(params)
        total, cf = w.sum(), torch.tensor(1e-4, device=dev)
        em_step_check(torch, f"K{k}", params, fused_em.em_partials(p4, W), total, cf, errs)
        parent = torch.randint(-1, -(-k // 8), (20_000,), generator=gen).to(dev)
        groups = fused_em.group_by_parent(p4, parent, 8, k)
        em_step_check(torch, f"K{k} grouped", params, fused_em.em_partials_grouped(groups, W), total, cf,
                      errs)
    torch.cuda.synchronize()


def em_step_check(torch, label, params, parts, total, cov_floor, errs) -> dict:
    """em_step (one launch) on an em_stats body's partial rows `parts`
    against its float32 twin (em_ref.em_step on the same rows) and a float64
    run of the twin from the same float32 statistics (em_ref.sum_partials),
    every covariance type: each output within EM_STEP_RTOL of the float64
    value plus EM_STEP_ATOL of the output's (for the table: the row's)
    largest float64 magnitude (the float32 twin's own gap to float64 is
    recorded beside it); an empty component: pi 0, Sigma I, its bias below
    -1e29; floor rows past K; logliks[it] within a float32 rounding of the
    rows' sum; a second launch bit-equal. Records the largest gap to the
    float32 twin in errs["em_step"]; returns the gaps."""
    from hgmm_torch import ops
    from hgmm_torch.ops import em_ref, fused_em
    from hgmm_torch.ops.gaussians import MixtureParams

    k = params.pi.shape[0]
    host = parts._replace(partial=parts.partial.cpu(),
                          parent_off=None if parts.parent_off is None else parts.parent_off.cpu())
    stats = em_ref.sum_partials(host)
    stats64 = em_ref.EmStats(stats.S.double(), stats.loglik.double())
    out = {}
    for cov_type in em_ref.COV_TYPES:
        fits = [ops.new_fit(params, 2, total, cov_floor, masked=parts.branch > 0) for _ in range(2)]
        fit = fits[0]
        rows = fit.table.wn.shape[0]
        twin = em_ref.new_fit(MixtureParams(*(a.cpu() for a in params)), 2, total.cpu(), cov_floor.cpu(),
                              rows)
        f64 = em_ref.new_fit(MixtureParams(*(a.cpu().double() for a in params)), 2,
                             total.cpu().double(), cov_floor.cpu().double(), rows)
        before = fused_em.LAUNCHES["em_step"]
        for f in fits:
            fused_em.em_step(parts, f, 1, 1e-6, cov_type)
        if fused_em.LAUNCHES["em_step"] != before + 2:
            raise CheckFailed("em_step: not one launch a call")
        if not all(torch.equal(a, b) for a, b in zip((*fits[0].params, fits[0].table.wn, fits[0].logliks),
                                                      (*fits[1].params, fits[1].table.wn, fits[1].logliks))):
            raise CheckFailed(f"em_step {label} {cov_type}: two launches differ")
        em_ref.em_step(host, twin, 1, 1e-6, cov_type)
        em_ref.em_step(stats64, f64, 1, 1e-6, cov_type)
        live = f64.pi > 0
        gaps = {}
        for name in ("pi", "mu", "sigma", "table"):
            g, t, e = ((x.table.wn[:k] if name == "table" else getattr(x, name)).double().cpu()
                       for x in (fit, twin, f64))
            if name == "table":  # live rows; each against its row's largest entry
                g, t, e = g[live], t[live], e[live]
                top = e.abs().amax(1, keepdim=True) if e.numel() else e
            else:
                top = e.abs().max() if e.numel() else torch.zeros(())
            if not bool(torch.isfinite(g).all()):
                raise CheckFailed(f"em_step {label} {cov_type}: non-finite {name}")
            kern, tw = (g - e).abs(), (t - e).abs()
            limit = EM_STEP_RTOL * e.abs() + EM_STEP_ATOL * top
            if not bool((kern <= limit).all()):
                raise CheckFailed(f"em_step {label} {cov_type}: {name} off the float64 run by "
                                  f"{float(kern.max())} (twin {float(tw.max())})")
            gaps[name] = {"kernel_vs_f64": float(kern.max()) if kern.numel() else 0.0,
                          "twin_vs_f64": float(tw.max()) if tw.numel() else 0.0,
                          "kernel_vs_twin": float((g - t).abs().max()) if g.numel() else 0.0}
            errs["em_step"] = max(errs.get("em_step", 0.0), gaps[name]["kernel_vs_twin"])
        wn = fit.table.wn.cpu()
        if bool((~live).any()):
            j = int(torch.nonzero(~live)[0])
            if not (float(fit.pi[j]) == 0.0 and torch.equal(fit.sigma[j].cpu(), torch.eye(3))
                    and float(wn[j, 9]) < -1e29):
                raise CheckFailed(f"em_step {label} {cov_type}: an empty component is not inert")
        if not (bool((wn[:, 10:] == 0).all()) and bool((wn[k:, :9] == 0).all())
                and bool((wn[k:, 9] == em_ref.NEG_INF).all())):
            raise CheckFailed(f"em_step {label} {cov_type}: the table's padding is wrong")
        lls = fit.logliks.cpu()
        if not (float(lls[0]) == 0.0 and abs(float(lls[1]) - float(stats.loglik))
                <= 2.0 ** -23 * abs(float(stats.loglik))):
            raise CheckFailed(f"em_step {label} {cov_type}: logliks {lls.tolist()}, rows' sum "
                              f"{float(stats.loglik)}")
        out[cov_type] = gaps
    return out


def split_rows(torch, part, nb, gen):
    """The float64 sum of part's rows split into nb float32 rows by random
    positive shares: other partial rows of about the same statistics."""
    share = torch.rand(nb, generator=gen, dtype=torch.float64).to(part.device) + 0.5
    return (part.double().sum(0)[None] * (share / share.sum())[:, None]).float().contiguous()


def reg_step_checks(torch, dev, gen, errs) -> None:
    """reg_step against its twin (em_ref.reg_step, float32 on the same
    partials) from one state, for both solvers and every (first, last), on
    reg_stats' rows and on 1, 33 and 528 rows (the odometry pair's 528: a
    full pass of the coalesced read and a ragged one): the pose within
    float32 rounding of the float64 solve, the outputs, the done flag; then
    a done scan changes nothing."""
    from hgmm_torch import ops
    from hgmm_torch.models.se3 import so3_exp
    from hgmm_torch.ops import em_ref, fused_em
    from hgmm_torch.ops.gaussians import pack_loglik_weights, precision_terms, sym_pack

    pts = torch.randn(5000, 3, generator=gen).to(dev)
    params = random_mixture(torch, 64, gen, dev)
    A, b, _ = precision_terms(params)
    prob = ops.reg_problem(pts, pack_loglik_weights(params), params.mu, sym_pack(A), b)
    for solver, nb in ((s_, nb_) for s_ in (0, 1) for nb_ in (None, 1, 33, 528)):
        for first, last in ((True, True), (True, False), (False, True)):
            scan = ops.new_scan(so3_exp(torch.tensor([0.05, 0.1, -0.1], device=dev)),
                                torch.tensor([0.1, 0.0, 0.2], device=dev), 3)
            scan.state[em_ref.SCAN_START:em_ref.SCAN_START + 12] = scan.state[:12] + 0.01
            scan.state[em_ref.SCAN_LL] = -7.0
            twin = em_ref.RegScan(*(t.cpu().clone() for t in scan))
            part = ops.reg_partials(prob, scan).clone()
            if nb is not None:
                part = split_rows(torch, part, nb, gen)
            ops.reg_step(part, scan, 1, solver, first, last, 1e-7)
            em_ref.reg_step(part.cpu(), twin, 1, solver, first, last, 1e-7)
            torch.cuda.synchronize()
            err = float((scan.state.cpu()[:24] - twin.state[:24]).abs().max())
            if not err < 2e-5:
                raise CheckFailed(f"reg_step solver {solver} nb {part.shape[0]} first {first} last {last}: "
                                  f"state off the twin's by {err}")
            close(torch, "reg_step.logliks", scan.logliks, twin.logliks, 1e-6, 0.0)
            close(torch, "reg_step.deltas", scan.deltas, twin.deltas, 1e-3, 1e-6)
            errs["reg_step"] = max(errs["reg_step"], err)
    scan.state[em_ref.SCAN_DONE] = 1.0
    before = scan.state.clone()
    ops.reg_step(ops.reg_partials(prob, scan), scan, 2, 1, True, True, 1e-7)
    if not (torch.equal(scan.state, before) and float(scan.logliks[2]) == float(before[em_ref.SCAN_LL_LAST])):
        raise CheckFailed("reg_step: a done scan changed or did not re-emit")
    if fused_em.plan_reg_stats(16_384, 512, None, torch.cuda.get_device_properties(dev).multi_processor_count).lanes < 2:
        raise CheckFailed("reg_stats: the odometry bucket was meant to run with lanes")


def new_kernel_edges(torch, dev, gen, errs) -> None:
    """The edges of the register-tiled em_stats (K >= 33 unmasked) and of the
    chunked, split knn, at small sizes; each result twice for equal bits."""
    from hgmm_torch.ops import em_ref, fused_em, knn, prepare
    from hgmm_torch.ops.gaussians import MixtureParams, pack_loglik_weights

    # K off the tiling (padded floor rows), every tile plan, ragged and tiny N,
    # zero-weight rows, an outlier logit, a dead component.
    for k in (65, 100, 513, 1024, 2048):
        params = random_mixture(torch, k, gen, dev, dead=(3,))
        W = pack_loglik_weights(params)
        for n in (1, 31, 300, 4097):
            pts = torch.randn(n, 3, generator=gen).to(dev)
            w = torch.rand(n, generator=gen).to(dev)
            w[::5] = 0.0
            for weights, outlier in ((None, None), (w, -3.0)):
                p4 = prepare(pts, weights).pts4
                got = fused_em.em_stats(p4, W, outlier)
                check_em(torch, "em_stats", got, em_ref.em_stats(pts, W, weights, outlier),
                         max(n, 300), errs)
                again = fused_em.em_stats(p4, W, outlier)
                if not (torch.equal(got.S, again.S) and torch.equal(got.loglik, again.loglik)):
                    raise CheckFailed(f"em_stats K={k} N={n}: two launches differ")
                if float(got.S[3].abs().max()) != 0.0:
                    raise CheckFailed(f"em_stats K={k} N={n}: a dead component got mass")
    # Every component dead: every point is dead, S and loglik are exactly 0.
    params = random_mixture(torch, 100, gen, dev)
    W = pack_loglik_weights(MixtureParams(torch.zeros_like(params.pi), params.mu, params.sigma))
    got = fused_em.em_stats(prepare(torch.randn(1000, 3, generator=gen).to(dev)).pts4, W)
    if float(got.S.abs().max()) != 0.0 or float(got.loglik) != 0.0:
        raise CheckFailed("em_stats: an all-dead mixture gave nonzero or non-finite statistics")

    # knn: fewer targets than a chunk, one query, a ragged last tile, more than
    # one target split, and every target equal (exact ties across chunk, tile
    # and split boundaries: index 0 must win everywhere).
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for nq, nt in ((1, 1), (1, 5000), (5000, 31), (2000, 513), (16_384, 16_384), (40_000, 1025)):
        q = torch.randn(nq, 3, generator=gen).to(dev)
        t = torch.randn(nt, 3, generator=gen).to(dev)
        q[: min(nq, nt) // 2] = t[: min(nq, nt) // 2]
        idx, d2 = knn.nearest_neighbor_cuda(q, t)
        check_knn(torch, q, t, idx, d2, *knn.nearest_neighbor_ref(q, t), errs, min_agree=0.98)
        again = knn.nearest_neighbor_cuda(q, t)
        if not (torch.equal(idx, again[0]) and torch.equal(d2, again[1])):
            raise CheckFailed(f"knn {nq} x {nt}: two launches differ")
        same = torch.full((nt, 3), 0.25, device=dev)
        if int(knn.nearest_neighbor_cuda(q, same)[0].abs().max()) != 0:
            raise CheckFailed(f"knn {nq} x {nt}: of equal targets a later one won")
    if not knn.plan_knn(16_384, 16_384, sms).splits > 1:
        raise CheckFailed("knn: the 16,384 x 16,384 case was meant to run with target splits")
    # A NaN target row never wins; the others are found as if it were far away.
    q = torch.randn(3000, 3, generator=gen).to(dev)
    t = torch.randn(5000, 3, generator=gen).to(dev)
    t[2500] = float("nan")
    idx, d2 = knn.nearest_neighbor_cuda(q, t)
    far = t.clone()
    far[2500] = 1e6
    check_knn(torch, q, far, idx, d2, *knn.nearest_neighbor_ref(q, far), errs, min_agree=0.98)
    if bool((idx == 2500).any()):
        raise CheckFailed("knn: a NaN target row won")
    small_k_edges(torch, dev, gen, errs)


def small_k_edges(torch, dev, gen, errs) -> None:
    """The first em_stats body (K <= 32, a point on 1 to 4 lanes; K = 63 on
    the tiled body's 64 padded rows) and assign at their edges: N = 1, ragged
    last warps, zero-weight rows, an outlier,
    an all-dead mixture, the packed table beside W, two launches for equal
    bits; assign on exact inputs (every logit exact in float32) with ties,
    parents -1 and past K bit-equal to the plain version, and a NaN logit
    that never wins."""
    from hgmm_torch.ops import em_ref, fused_em, prepare
    from hgmm_torch.ops.gaussians import MixtureParams, pack_loglik_weights

    for k in (1, 3, 8, 16, 32, 63):
        params = random_mixture(torch, k, gen, dev, dead=(0,) if k > 1 else ())
        W = pack_loglik_weights(params)
        for n in (1, 31, 300, 4097):
            pts = torch.randn(n, 3, generator=gen).to(dev)
            w = torch.rand(n, generator=gen).to(dev)
            w[::5] = 0.0
            for weights, outlier in ((None, None), (w, -3.0)):
                p4 = prepare(pts, weights).pts4
                got = fused_em.em_stats(p4, W, outlier)
                check_em(torch, "em_stats", got, em_ref.em_stats(pts, W, weights, outlier),
                         max(n, 300), errs)
                again = fused_em.em_stats(p4, em_ref.pack_table(W, fused_em.table_rows(k)), outlier)
                if not (torch.equal(got.S, again.S) and torch.equal(got.loglik, again.loglik)):
                    raise CheckFailed(f"em_stats K={k} N={n}: two launches differ")
                if k > 1 and float(got.S[0].abs().max()) != 0.0:
                    raise CheckFailed(f"em_stats K={k} N={n}: a dead component got mass")
    dead = random_mixture(torch, 8, gen, dev)
    W = pack_loglik_weights(MixtureParams(torch.zeros_like(dead.pi), dead.mu, dead.sigma))
    got = fused_em.em_stats(prepare(torch.randn(1000, 3, generator=gen).to(dev)).pts4, W)
    if float(got.S.abs().max()) != 0.0 or float(got.loglik) != 0.0:
        raise CheckFailed("em_stats K=8: an all-dead mixture gave nonzero statistics")

    for k, branch in ((1, None), (5, None), (8, None), (64, 8), (64, 3), (100, 8), (512, 8)):
        for n in (1, 33, 50_000):
            pts = (torch.randint(-8, 9, (n, 3), generator=gen).float() / 4).to(dev)
            W = (torch.randint(-8, 9, (10, k), generator=gen).float() / 16).to(dev)
            W[:, k // 2:] = W[:, : k - k // 2].clone()  # exact ties
            parent = None
            if branch is not None:
                parent = torch.randint(-1, -(-k // branch) + 2, (n,), generator=gen,
                                       dtype=torch.int32).to(dev)
            got = fused_em.assign(prepare(pts).pts4, W, parent, branch)
            if not torch.equal(got, em_ref.assign(pts, W, parent, branch)):
                raise CheckFailed(f"assign K={k} branch={branch} N={n}: differs from the plain "
                                  f"version on exact inputs")
            if k > 1:
                Wn = W.clone()
                Wn[0, 1] = float("nan")  # component 1's logit is NaN for every point
                if bool((fused_em.assign(prepare(pts).pts4, Wn, parent, branch) == 1).any()):
                    raise CheckFailed(f"assign K={k} branch={branch} N={n}: a NaN logit won")


def make_pair(torch, n, dev):
    from hgmm_torch.data.synthetic import make_cloud
    from hgmm_torch.models.se3 import Pose, so3_exp

    cloud = make_cloud(n, "trefoil", seed=4, device=dev)
    gt = Pose(so3_exp(torch.tensor(GT_OMEGA, device=dev)), torch.tensor(GT_T, device=dev))
    return gt.inverse().apply(cloud), cloud, gt


def preset_kwargs():
    from hgmm_torch.configs.presets import PRESETS

    p = PRESETS["config2_tree_8x3"]
    return dict(model_kind=p.model_kind, branch=p.branch, levels=p.levels, fit_iters=p.fit_iters,
                complexity_threshold=p.complexity_threshold, n_iters=p.reg_iters, method=p.method,
                top_k=p.top_k, outlier_logit=p.outlier_logit)


def pose_errors(source, pose, gt):
    from hgmm_torch.eval.metrics import (pose_delta_norm, registration_rmse, rotation_error_deg,
                                         translation_error)

    return {"rmse": float(registration_rmse(pose, source, gt)),
            "rot_deg": float(rotation_error_deg(pose, gt)),
            "trans": float(translation_error(pose, gt)),
            "pose_delta": float(pose_delta_norm(pose, gt))}


def main_path(torch, dev):
    """register_pair with config2_tree_8x3 on the 437,645-point pair."""
    import hgmm_torch
    from hgmm_torch.ops import fused_em

    source, target, gt = make_pair(torch, N_POINTS, dev)
    torch.cuda.synchronize()
    fused_em.reset_launches()
    t0 = time.perf_counter()
    res = hgmm_torch.register_pair(source, target=target, generator=torch.Generator().manual_seed(0),
                                   **preset_kwargs())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(fused_em.LAUNCHES)
    errors = pose_errors(source, res.pose, gt)
    finite = all(bool(torch.isfinite(x).all()) for x in (res.pose.R, res.pose.t, res.logliks, res.deltas))
    if not finite:
        raise CheckFailed("main path: non-finite output")
    if res.logliks.shape != (3 * 50,) or res.deltas.shape != (3 * 50,):
        raise CheckFailed(f"main path: logliks/deltas of shape {tuple(res.logliks.shape)}")
    for key, bound in BOUNDS.items():
        if not errors[key] < bound:
            raise CheckFailed(f"main path: {key} = {errors[key]} not below {bound}")
    require_launched(counts, "register_pair")
    return counts, {"n_source": N_POINTS, "n_target": N_POINTS, "wall_s": wall, "errors": errors,
                    "bounds": BOUNDS, "converged": bool(res.converged),
                    "final_loglik": float(res.logliks[-1])}


def require_launched(counts, path):
    missing = [name for name in PATH_KERNELS[path] if counts[name] == 0]
    if missing:
        raise CheckFailed(f"{path}: kernels never launched: {missing}")



def add_bound(name, entry) -> None:
    """bound_ms, bound_by and share_of_bound of one timed shape, from
    hgmm_torch.eval.roofline.kernel_bound on this entry's own shape."""
    from hgmm_torch.eval.roofline import kernel_bound

    if name in ("em_stats", "em_stats_masked"):
        kb = kernel_bound(name, n=entry["n"], k=entry["k"], branch=8)
    elif name == "assign":
        kb = kernel_bound(name, n=entry["n"], k=entry["k"], branch=8 if entry["masked"] else None)
    elif name == "reg_stats":
        kb = kernel_bound(name, n=entry["n"], k=entry["k"], top_k=entry.get("top_k"))
    elif name == "reg_step":
        kb = kernel_bound(name, nb=entry["nb"])
    elif name == "em_step":
        kb = kernel_bound(name, k=entry["k"], rows=entry["rows"], nb=entry["nb"], branch=entry["branch"])
    elif name == "knn":
        kb = kernel_bound(name, nq=entry["nq"], nt=entry["nt"])
    else:
        kb = kernel_bound(name, **entry["bound_args"])
    entry.update(bound_ms=kb.seconds * 1e3, bound_by=kb.by,
                 share_of_bound=kb.seconds * 1e3 / entry["ms"])
    if entry["share_of_bound"] > MAX_SHARE:
        raise CheckFailed(f"{name} {entry}: {entry['share_of_bound']:.3f} of its bound: a wrong count")


def probe_checks(torch, dev, errs) -> dict:
    """Each probe kernel against its plain version on the card: at small
    steps, and at every shape and loop that the probes phase then times."""
    from hgmm_torch.benchmarks.kernel_compare import norm_operands
    from hgmm_torch.benchmarks.mxu_microbench import make_inputs
    from hgmm_torch.ops import probes

    report = {}

    # compute-sanitizer does not support the card as the check machine exposes
    # it, so the run guards itself. Sentinel blocks of both of the allocator's
    # pools, every other one freed again: the wrappers' outputs and scratch land
    # in the holes, and a write past their ends lands in a sentinel.
    sentinels = [torch.full((size // 4,), SENTINEL, dtype=torch.int32, device=dev)
                 for size in (1 << 19, 3 << 20, 5 << 20) for _ in range(24)]
    del sentinels[::2]

    def hold(name, label, kern, plain, mode, chain):
        got = kern()
        torch.cuda.synchronize()  # a fault in the kernel shows here, not in a later op
        ref = plain()
        first = got.cpu(), ref.cpu()
        rtol, arel = PROBE_TOL[mode]
        top = float(ref.abs().max())
        chain *= PROBE_CHAIN.get(label.split("_K")[0], 1)
        e = close(torch, label, got, ref, rtol + chain, (arel + chain) * top)
        # The kernels sum in a fixed order: a second launch gives the same bits,
        # unless blocks or warps race. And nothing is in flight now: a value that
        # reads differently the second time was written by a stray store.
        if not torch.equal(kern(), got):
            raise CheckFailed(f"{label}: two launches on the same inputs differ")
        if not (torch.equal(got.cpu(), first[0]) and torch.equal(ref.cpu(), first[1])):
            raise CheckFailed(f"{label}: a result changed between two reads")
        errs[name] = max(errs[name], e)
        report[label] = e / top

    def hold_vpu(x, steps, reps, tag):
        for mode in ("exp2", "cast"):
            got, ref = probes.vpu_cuda(x, steps, reps, mode), probes.vpu_ref(x, steps, reps, mode)
            # Every value is a bfloat16; exp2f may differ from torch.exp2 in the
            # last place, which moves the rounded value by one bfloat16 ulp at most.
            ulp = (got.to(torch.bfloat16).view(torch.int16).int()
                   - ref.to(torch.bfloat16).view(torch.int16).int()).abs()
            off = int((ulp > 0).sum())
            if int(ulp.max()) > (1 if mode == "exp2" else 0) or not bool(torch.isfinite(got).all()):
                raise CheckFailed(f"probe_vpu {mode} {tag}: {off} elements differ, by up to "
                                  f"{int(ulp.max())} bfloat16 ulp")
            errs["probe_vpu"] = max(errs["probe_vpu"], float((got - ref).abs().max()))
            report[f"vpu_{mode}_{tag}_elements_off_by_one_ulp"] = off

    for k, t in PROBE_CHECK_SHAPES:
        ins = make_inputs(k, t, dev)
        norm_a = norm_operands(torch, k, dev)
        for steps, reps in PROBE_CHECK_LOOPS + probe_timed_loops(k, t):
            # Kernel and plain version add the steps * reps products in the same
            # order; past the small loops each of those float32 adds may round
            # differently on products that differ in their last bits.
            chain = steps * reps * 2.0 ** -24 if (steps, reps) not in PROBE_CHECK_LOOPS else 0.0
            tag = f"K{k}_T{t}_{steps}x{reps}"
            for mode, sfx in (("bf16", ""), ("f32", "_f32")):
                wt, phi, e = ins["wt" + sfx], ins["phi" + sfx], ins["e" + sfx]
                hold("probe_logits", f"logits_{mode}_{tag}",
                     lambda: probes.logits_cuda(wt, phi, steps, reps),
                     lambda: probes.logits_ref(wt, phi, steps, reps), mode, chain)
                hold("probe_stats", f"stats_{mode}_{tag}",
                     lambda: probes.stats_cuda(phi[:32], e, steps, reps),
                     lambda: probes.stats_ref(phi[:32], e, steps, reps), mode, chain)
            for label, ones in ((f"norm_bf16_{tag}", ins["ones"]),
                                (f"norm_bf16_random_a_{tag}", norm_a["random"])):
                hold("probe_norm", label, lambda: probes.norm_cuda(ones, ins["e"], steps, reps),
                     lambda: probes.norm_ref(ones, ins["e"], steps, reps), "bf16", chain)
            # Two float32 adds an element and rep in the plain version's order: equal.
            got = probes.addonly_cuda(ins["x"], steps, reps)
            ref = probes.addonly_ref(ins["x"], steps, reps)
            if not torch.equal(got, ref):
                raise CheckFailed(f"probe_addonly {tag}: differs from the plain version by "
                                  f"{float((got - ref).abs().max())}")
            if (steps, reps) in PROBE_CHECK_LOOPS:
                hold_vpu(ins["x"].clamp(-1.5, -0.5), steps, reps, tag)
        wt0, phi32_0 = torch.zeros_like(ins["wt"]), torch.zeros_like(ins["phi"][:32])
        for steps, reps in PROBE_ZERO_A_LOOPS:
            tag = f"K{k}_T{t}_{steps}x{reps}"
            hold("probe_logits", f"logits_bf16_zero_a_{tag}",
                 lambda: probes.logits_cuda(wt0, ins["phi"], steps, reps),
                 lambda: probes.logits_ref(wt0, ins["phi"], steps, reps), "bf16", 0.0)
            hold("probe_stats", f"stats_bf16_zero_a_{tag}",
                 lambda: probes.stats_cuda(phi32_0, ins["e"], steps, reps),
                 lambda: probes.stats_ref(phi32_0, ins["e"], steps, reps), "bf16", 0.0)
            hold("probe_norm", f"norm_bf16_zero_a_{tag}",
                 lambda: probes.norm_cuda(norm_a["zero"], ins["e"], steps, reps),
                 lambda: probes.norm_ref(norm_a["zero"], ins["e"], steps, reps), "bf16", 0.0)
    vk, vt = VPU_LOOP["k"], VPU_LOOP["t"]
    x = make_inputs(vk, vt, dev)["x"].clamp(-1.5, -0.5)
    for reps in (VPU_LOOP["r1"], VPU_LOOP["r2"]):
        hold_vpu(x, VPU_LOOP["steps"], reps, f"K{vk}_T{vt}_{VPU_LOOP['steps']}x{reps}")
    torch.cuda.synchronize()
    if not all(bool((blk == SENTINEL).all()) for blk in sentinels):
        raise CheckFailed("probe_checks: a sentinel block beside the kernels' buffers was written")
    return report


def probe_timed_loops(k: int, t: int) -> tuple:
    """The (steps, reps) that the probes phase times at this shape."""
    if (k, t) not in MXU_SHAPES:
        return ()
    return ((MXU_LOOP["steps"], MXU_LOOP["r1"]), (MXU_LOOP["steps"], MXU_LOOP["r2"]))


def check_shares(what, shares) -> None:
    bad = {k: v for k, v in shares.items() if not (v == v and 0.0 < v <= MAX_SHARE)}
    if bad:
        raise CheckFailed(f"{what}: shares outside (0, {MAX_SHARE}]: {bad}: a wrong count or a "
                          f"timing lost in the noise")


def probes_phase(torch, dev, timings):
    """The two microbenchmarks at the reference's defaults, with the counters
    at 0 just before; then each probe's headline time (steps and the larger rep
    count of the microbenchmark, K=512, T=2048) beside its plain version's and,
    for the matrix probes, torch.matmul's for the same steps * reps products
    (in one CUDA graph; the eager calls beside it)."""
    from hgmm_torch.benchmarks import mxu_microbench, vpu_microbench
    from hgmm_torch.benchmarks.kernel_compare import graph_us
    from hgmm_torch.benchmarks.mxu_microbench import make_inputs
    from hgmm_torch.ops import fused_em, probes

    torch.cuda.synchronize()
    fused_em.reset_launches()
    mxu = [mxu_microbench.run(k, t, device=dev, **MXU_LOOP) for k, t in MXU_SHAPES]
    vpu = vpu_microbench.run(device=dev, **VPU_LOOP)
    torch.cuda.synchronize()
    counts = dict(fused_em.LAUNCHES)
    require_launched(counts, "probes")
    for rep in mxu:
        check_shares(f"mxu_microbench K={rep['k']}",
                     {name: c["share_of_peak_raw"] for name, c in rep["cases"].items()})
    check_shares("vpu_microbench", {"exp2": vpu["exp2_share_of_sfu_peak"]})
    log({"phase": "probes", "mxu": mxu, "vpu": vpu, "launches": counts})

    k, t = MXU_SHAPES[0]
    steps, reps = MXU_LOOP["steps"], MXU_LOOP["r2"]
    ins = make_inputs(k, t, dev)
    phi32 = ins["phi"][:32]

    def matmuls(a, b):
        out = torch.empty((a.shape[0], b.shape[1]), dtype=a.dtype, device=dev)
        return lambda: torch.matmul(a, b, out=out)

    def record(name, kern, plain, library, **bound_args):
        calls = steps * reps
        timings[name].append({
            **bound_args, "ms": cuda_ms(torch, kern, reps=5, warmup=1),
            "plain_ms": cuda_ms(torch, plain, reps=1, warmup=1),
            # The steps * reps calls captured in one CUDA graph (the card's
            # time, no host dispatch between launches), and queued eagerly.
            "library_ms": None if library is None else graph_us(torch, library, calls, 2) * calls / 1e3,
            "library_eager_ms": None if library is None else cuda_ms(
                torch, lambda: [library() for _ in range(calls)], reps=1, warmup=1),
            "library": None if library is None else f"{calls} x torch.matmul in one CUDA graph",
            "bound_args": bound_args, "headline": True})

    loop = dict(k=k, t=t, steps=steps, reps=reps)
    record("probe_logits", lambda: probes.logits_cuda(ins["wt"], ins["phi"], steps, reps),
           lambda: probes.logits_ref(ins["wt"], ins["phi"], steps, reps),
           matmuls(ins["wt"], ins["phi"]), dtype="bf16", **loop)
    record("probe_stats", lambda: probes.stats_cuda(phi32, ins["e"], steps, reps),
           lambda: probes.stats_ref(phi32, ins["e"], steps, reps),
           matmuls(phi32, ins["e"].T), dtype="bf16", **loop)
    record("probe_norm", lambda: probes.norm_cuda(ins["ones"], ins["e"], steps, reps),
           lambda: probes.norm_ref(ins["ones"], ins["e"], steps, reps),
           matmuls(ins["ones"], ins["e"]), **loop)
    record("probe_addonly", lambda: probes.addonly_cuda(ins["x"], steps, reps),
           lambda: probes.addonly_ref(ins["x"], steps, reps), None, **loop)
    vk = dict(k=VPU_LOOP["k"], t=VPU_LOOP["t"], steps=VPU_LOOP["steps"], reps=VPU_LOOP["r2"])
    x = ins["x"][: vk["k"], : vk["t"]].contiguous().clamp(-1.5, -0.5)
    record("probe_vpu", lambda: probes.vpu_cuda(x, vk["steps"], vk["reps"], "exp2"),
           lambda: probes.vpu_ref(x, vk["steps"], vk["reps"], "exp2"), None, mode="exp2", **vk)
    return counts


def cli_bench(torch, dev, errs, timings):
    """`bench` through the CLI at full size with the counters at 0 just
    before; then the sweep's kernel against its plain version at that size."""
    import math

    from hgmm_torch import bench, convert
    from hgmm_torch.ops import em_ref, fused_em, prepare
    from hgmm_torch.ops.gaussians import pack_loglik_weights

    torch.cuda.synchronize()
    fused_em.reset_launches()
    t0 = time.perf_counter()
    out = run_cli(["bench", "--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(fused_em.LAUNCHES)
    lines = [ln for ln in out.splitlines() if ln.strip()]
    if len(lines) != 1:
        raise CheckFailed(f"cli bench: {len(lines)} lines on stdout, expected one JSON line")
    rec = json.loads(lines[0])
    if set(rec) != {"metric", "value", "unit", "vs_baseline"}:
        raise CheckFailed(f"cli bench: keys {sorted(rec)}")
    if not (math.isfinite(rec["value"]) and rec["value"] > 0 and math.isfinite(rec["vs_baseline"])):
        raise CheckFailed(f"cli bench: {rec}")
    if rec["vs_baseline"] > MAX_SHARE:
        raise CheckFailed(f"cli bench: vs_baseline {rec['vs_baseline']} above {MAX_SHARE}: a share "
                          f"over 105 % of a roofline is a wrong count")
    if counts["em_stats"] < bench.SWEEPS:
        raise CheckFailed(f"cli bench: em_stats launched {counts['em_stats']} times, fewer than "
                          f"one chain's {bench.SWEEPS}")
    require_launched(counts, "cli_bench")

    # The same problem again (the kernel sums in a fixed order, so this is the
    # chain's last sweep), against the plain version at N = 2^21.
    mix, pts_np = bench.bench_problem()
    W = pack_loglik_weights(convert.mixture_from_numpy(*mix, device=dev))
    pts = torch.from_numpy(pts_np).to(dev)
    prep = prepare(pts)
    n, k = pts.shape[0], W.shape[1]
    check_em(torch, "em_stats", fused_em.em_stats(prep.pts4, W), em_ref.em_stats(pts, W), n, errs)
    timings["em_stats"].append({"k": k, "n": n, "masked": False, "bench": True,
                                "ms": cuda_ms(torch, lambda: fused_em.em_stats(prep.pts4, W)),
                                "plain_ms": cuda_ms(torch, lambda: em_ref.em_stats(pts, W), reps=2,
                                                    warmup=1), "headline": False})
    log({"phase": "cli_bench", "wall_s": wall, "record": rec, "n": n, "k": k,
         "sweeps": bench.SWEEPS, "launches": counts, "kernel": timings["em_stats"][-1]})
    return counts


def kernel_shapes_phase(dev) -> None:
    """benchmarks/kernel_shapes at N = 2^21: five rows, each against its bound."""
    from hgmm_torch.benchmarks import kernel_shapes

    rows = kernel_shapes.run(device=dev)
    check_shares("kernel_shapes", {f"K{r['k']}{'m' if r['masked'] else ''}": r["share_of_bound"]
                                   for r in rows})
    log({"phase": "kernel_shapes", "rows": rows})


def slice_checks(torch, dev, errs):
    """Time the fit and the registration apart, then check and time every
    kernel against its plain version at the slice's shapes."""
    from hgmm_torch.models.gmm_tree import GmmTree
    from hgmm_torch.ops import em_ref, fused_em, prepare
    from hgmm_torch.ops.gaussians import pack_loglik_weights
    from hgmm_torch.pipelines.register import model_terms, register_tree

    kw = preset_kwargs()
    source, target, gt = make_pair(torch, N_POINTS, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tree, _ = GmmTree.fit(target, branch=kw["branch"], levels=kw["levels"], em_iters=kw["fit_iters"],
                          generator=torch.Generator().manual_seed(0))
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = register_tree(source, tree, n_iters=kw["n_iters"], method=kw["method"],
                        complexity_threshold=kw["complexity_threshold"])
    torch.cuda.synchronize()
    reg_s = time.perf_counter() - t0
    n_live = int((res.deltas >= 1e-7).sum())
    log({"phase": "timed_run", "fit_s": fit_s, "register_s": reg_s,
         "live_iterations": n_live, "register_ms_per_live_iteration": 1e3 * reg_s / max(n_live, 1),
         "errors": pose_errors(source, res.pose, gt)})

    timings = {name: [] for name in fused_em.LAUNCHES}
    tgt = prepare(target)
    src = prepare(source)
    Ws = [pack_loglik_weights(p) for p in tree.levels]
    parents = [None, fused_em.assign(tgt.pts4, Ws[0])]
    parents.append(fused_em.assign(tgt.pts4, Ws[1], parents[1], 8))
    n = N_POINTS

    def record(name, k, kern, plain, headline=False, **extra):
        timings[name].append({"k": k, "n": n, "masked": name in ("em_stats_masked", "assign") and k > 8,
                              "ms": device_ms(torch, kern), "call_ms": cuda_ms(torch, kern),
                              "plain_ms": cuda_ms(torch, plain, reps=5), "headline": headline, **extra})

    # Tree fit: level 0 unmasked at K=8, levels 1-2 masked at K=64 and 512.
    W0 = Ws[0]
    check_em(torch, "em_stats", fused_em.em_stats(tgt.pts4, W0), em_ref.em_stats(target, W0), n, errs)
    # "ms": the public call, body and reduce; "body_ms": the body alone, as a
    # fit's sweep launches it (em_step sums its rows).
    record("em_stats", 8, lambda: fused_em.em_stats(tgt.pts4, W0), lambda: em_ref.em_stats(target, W0),
           headline=True, body_ms=device_ms(torch, lambda: fused_em.em_partials(tgt.pts4, W0)))
    check_assign(torch, fused_em.assign(tgt.pts4, W0), em_ref.assign(target, W0), target, W0,
                 None, None, errs)
    record("assign", 8, lambda: fused_em.assign(tgt.pts4, W0), lambda: em_ref.assign(target, W0))
    for lvl in (1, 2):
        W, par = Ws[lvl], parents[lvl]
        k = W.shape[1]
        check_em(torch, "em_stats_masked", fused_em.em_stats_masked(tgt.pts4, W, par, 8),
                 em_ref.em_stats_masked(target, W, par, 8), n, errs)
        groups = fused_em.group_by_parent(tgt.pts4, par, 8, k)
        record("em_stats_masked", k, lambda: fused_em.em_stats_grouped(groups, W),
               lambda: em_ref.em_stats_masked(target, W, par, 8), headline=lvl == 2,
               wrapper_ms=cuda_ms(torch, lambda: fused_em.em_stats_masked(tgt.pts4, W, par, 8)),
               body_ms=device_ms(torch, lambda: fused_em.em_partials_grouped(groups, W)),
               group_ms=cuda_ms(torch, lambda: fused_em.group_by_parent(tgt.pts4, par, 8, k)),
               chunks=groups.n_chunks, chunk_points=groups.chunk_points)
        check_assign(torch, fused_em.assign(tgt.pts4, W, par, 8), em_ref.assign(target, W, par, 8),
                     target, W, par, 8, errs)
        record("assign", k, lambda: fused_em.assign(tgt.pts4, W, par, 8),
               lambda: em_ref.assign(target, W, par, 8), headline=lvl == 2)
    # em_step on each level's E-step body's partial rows, on that level's
    # table, as the sweeps launch it: held to its twin (em_step_check) and
    # timed, the twin on the same rows on the card beside it.
    from hgmm_torch import ops
    from hgmm_torch.models.gmm import scene_variance

    total, cf = torch.tensor(float(n), device=dev), 1e-4 * scene_variance(target)
    for lvl, params in enumerate(tree.levels):
        parts = (fused_em.em_partials(tgt.pts4, Ws[0]) if lvl == 0 else fused_em.em_partials_grouped(
            fused_em.group_by_parent(tgt.pts4, parents[lvl], 8, Ws[lvl].shape[1]), Ws[lvl]))
        em_step_check(torch, f"level {lvl}", params, parts, total, cf, errs)
        fit = ops.new_fit(params, 1, total, cf, masked=lvl > 0)
        twin = em_ref.new_fit(params, 1, total, cf, fit.table.wn.shape[0])
        timings["em_step"].append({
            "k": params.pi.shape[0], "rows": fit.table.wn.shape[0], "n": n, "headline": lvl == 2,
            "nb": parts.n_rows, "branch": parts.branch or None,
            "ms": device_ms(torch, lambda: fused_em.em_step(parts, fit, 0)),
            "call_ms": cuda_ms(torch, lambda: fused_em.em_step(parts, fit, 0)),
            "plain_ms": cuda_ms(torch, lambda: em_ref.em_step(parts, twin, 0), reps=5)})
    # Registration: levels 0 and 1, then the adaptive cut, at the final pose.
    pose = (res.pose.R, res.pose.t)
    for lvl, params in enumerate((tree.levels[0], tree.levels[1],
                                  tree.cut_mixture(kw["complexity_threshold"]))):
        W, mu, A6, b3 = model_terms(params)
        k = W.shape[1]
        check_reg(torch, fused_em.reg_stats(src.pts4, W, mu, A6, b3, pose),
                  em_ref.reg_stats(source, W, mu, A6, b3, pose), n, errs)
        # "ms": the launch a scan makes each step (tables built once);
        # "wrapper_ms": the standalone call, tables and the reduction included.
        tab = fused_em.reg_tables(src.pts4, W, mu, A6, b3)
        pose12 = torch.cat([pose[0].reshape(9), pose[1]]).contiguous()
        record("reg_stats", k, lambda: fused_em.reg_partials(tab, pose12),
               lambda: em_ref.reg_stats(source, W, mu, A6, b3, pose), headline=lvl == 2,
               wrapper_ms=cuda_ms(torch, lambda: fused_em.reg_stats(src.pts4, W, mu, A6, b3, pose)),
               lanes=tab.plan.lanes, blocks=tab.plan.blocks)
    # reg_step on the leaves' partials at the final pose, as the main path's
    # last level launches it (a WLS step; tol 0 never sets done).
    scan = fused_em.new_scan(pose[0], pose[1], 1)
    twin = em_ref.RegScan(*(t.clone() for t in scan))
    part = fused_em.reg_partials(tab, scan.state).clone()
    timings["reg_step"].append({
        "nb": part.shape[0], "k": k, "n": n, "headline": True,
        "ms": device_ms(torch, lambda: fused_em.reg_step(part, scan, 0, 1, True, True, 0.0)),
        "plain_ms": cuda_ms(torch, lambda: em_ref.reg_step(part, twin, 0, 1, True, True, 0.0), reps=5)})
    log({"phase": "slice_kernels", "timings": timings, "max_abs_err": errs})
    return timings


def profiled(torch, fn, trace_dir) -> dict:
    """fn() once to warm up; once with the host syncs counted (torch's sync
    debug mode) and the wall clock; once under the profiler: the device's
    kernels, copies and memsets, its busy time, the port's kernels' time."""
    from hgmm_torch.utils.profiling import count_syncs, device_busy, device_launches, trace

    fn()
    torch.cuda.synchronize()
    with count_syncs() as syncs:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    with trace(trace_dir):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        profiled_wall = time.perf_counter() - t0
    busy_us, kernel_us = device_busy(trace_dir / "trace.json")
    return {"wall_s": wall, "host_syncs": syncs["syncs"],
            "host_sync_sites": sorted(syncs["sites"].items(), key=lambda kv: -kv[1])[:12],
            **device_launches(trace_dir / "trace.json"),
            "profiled_wall_s": profiled_wall, "device_busy_us": busy_us,
            "port_kernels_us": sum(v for k, v in kernel_us.items() if "hgmm::" in k),
            "device_idle_share": 1.0 - busy_us * 1e-6 / wall,
            "top_device_us": [(k[:80], v) for k, v in sorted(kernel_us.items(), key=lambda kv: -kv[1])[:8]]}


def pair_accounting(torch, dev, work) -> dict:
    """register_pair on the main path's pair, as main_path runs it: launches
    and host syncs a pair beside its seconds."""
    import hgmm_torch

    source, target, _ = make_pair(torch, N_POINTS, dev)
    return profiled(torch, lambda: hgmm_torch.register_pair(
        source, target=target, generator=torch.Generator().manual_seed(0), **preset_kwargs()),
        work / "pair_trace")


def sweep_accounting(torch, dev, work) -> dict:
    """A fit's sweeps on the card as the tree fit runs them on the main
    path's target (config2_tree_8x3: 10 sweeps a level): the flat K = 8 level
    (the first em_stats body) and the grouped K = 64 level (the masked body),
    each through models.gmm.em_sweeps with torch's sync debug mode set to
    "error" (a host sync raises); one E-step and one em_step launch a sweep
    by the counters, and SWEEP_KERNELS kernels a sweep, all the port's, by
    the profiler (the kernels of 2s sweeps less those of s, over s). Then the
    tree fit on the card against the same fit through the plain versions on
    the CPU, on 40,000 of the target's points from one init: each level's
    per-point loglik within FIT_LL_RTOL."""
    import json as _json

    from hgmm_torch import ops
    from hgmm_torch.models.gmm import em_sweeps, init_params, scene_variance, total_weight
    from hgmm_torch.models.gmm_tree import GmmTree, seed_children
    from hgmm_torch.ops import fused_em
    from hgmm_torch.utils.profiling import trace

    kw = preset_kwargs()
    sweeps, branch = kw["fit_iters"], kw["branch"]
    _, target, _ = make_pair(torch, N_POINTS, dev)
    prep = ops.prepare(target)
    total, cf = total_weight(target, None), 1e-4 * scene_variance(target)
    init = init_params(target, branch, torch.Generator().manual_seed(0))
    level0 = em_sweeps(prep, init, sweeps, total, cf)
    groups = ops.group_by_parent(prep, ops.assign(prep, level0.table), branch, branch * branch)
    out = {"sweeps": sweeps, "n": N_POINTS}
    for name, data, start, estep in (("flat_K8", prep, init, "em_stats"),
                                     ("grouped_K64", groups, seed_children(level0.params, branch),
                                      "em_stats_masked")):
        em_sweeps(data, start, sweeps, total, cf)
        torch.cuda.synchronize()
        fused_em.reset_launches()
        torch.cuda.set_sync_debug_mode("error")
        try:
            t0 = time.perf_counter()
            fit = em_sweeps(data, start, sweeps, total, cf)
            enqueue_s = time.perf_counter() - t0
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        counts = {key: v for key, v in fused_em.LAUNCHES.items() if v}
        if counts != {estep: sweeps, "em_step": sweeps}:
            raise CheckFailed(f"sweeps {name}: launches {counts}, expected {sweeps} of {estep} and em_step")
        if not bool(torch.isfinite(fit.logliks).all()):
            raise CheckFailed(f"sweeps {name}: non-finite logliks")
        kernels = {}
        for s_ in (sweeps, 2 * sweeps):
            d = work / f"sweep_trace_{name}_{s_}"
            with trace(d):
                em_sweeps(data, start, s_, total, cf)
                torch.cuda.synchronize()
            events = [e for e in _json.loads((d / "trace.json").read_text())["traceEvents"]
                      if e.get("cat") == "kernel" and "dur" in e]
            kernels[s_] = (len(events), sum("hgmm::" in e.get("name", "") for e in events))
            shutil.rmtree(d, ignore_errors=True)
        per_sweep = (kernels[2 * sweeps][0] - kernels[sweeps][0]) / sweeps
        port_per_sweep = (kernels[2 * sweeps][1] - kernels[sweeps][1]) / sweeps
        if per_sweep != SWEEP_KERNELS or port_per_sweep != SWEEP_KERNELS:
            raise CheckFailed(f"sweeps {name}: {per_sweep} kernels a sweep ({port_per_sweep} of the "
                              f"port's), expected {SWEEP_KERNELS}")
        out[name] = {"launches": counts, "kernels_per_sweep": per_sweep,
                     "port_kernels_per_sweep": port_per_sweep,
                     "kernels_outside_the_sweeps": kernels[sweeps][0] - sweeps * per_sweep,
                     "host_syncs_in_sweeps": 0, "enqueue_s": enqueue_s, "wall_s": wall_s,
                     "ms_per_sweep": 1e3 * wall_s / sweeps}

    # The tree fit on the card and through the plain versions, from one init.
    idx = torch.randperm(N_POINTS, generator=torch.Generator().manual_seed(1))[:40_000]
    sub = target.cpu()[idx]
    init_sub = init_params(sub, branch, torch.Generator().manual_seed(2))
    per_point = {}
    for d in (dev, torch.device("cpu")):
        _, lls = GmmTree.fit(sub.to(d), branch=branch, levels=kw["levels"], em_iters=sweeps,
                             init0=type(init_sub)(*(a.to(d) for a in init_sub)))
        per_point[d.type] = (lls.double().cpu() / sub.shape[0]).tolist()
    gaps = [abs(a - b) / abs(b) for a, b in zip(per_point["cuda"], per_point["cpu"])]
    if not all(g <= FIT_LL_RTOL for g in gaps):
        raise CheckFailed(f"tree fit on the card vs the plain versions: per-point logliks "
                          f"{per_point}, relative gaps {gaps} above {FIT_LL_RTOL}")
    out["tree_fit_vs_plain"] = {"n": sub.shape[0], "per_point_loglik": per_point,
                                "relative_gaps": gaps, "rtol": FIT_LL_RTOL}
    return out


def cpu_agreement(torch, dev):
    """register_pair on the card (kernels) and on the CPU (plain versions),
    same 4,000-point pair and seed: both meet the bounds and agree."""
    import hgmm_torch
    from hgmm_torch.eval.metrics import pose_delta_norm
    from hgmm_torch.models.se3 import Pose

    out = {}
    poses = {}
    for name, d in (("cuda", dev), ("cpu", torch.device("cpu"))):
        source, target, gt = make_pair(torch, 4000, d)
        res = hgmm_torch.register_pair(source, target=target,
                                       generator=torch.Generator().manual_seed(0), **preset_kwargs())
        out[name] = pose_errors(source, res.pose, gt)
        for key, bound in BOUNDS.items():
            if not out[name][key] < bound:
                raise CheckFailed(f"{name} 4k pair: {key} = {out[name][key]} not below {bound}")
        poses[name] = Pose(res.pose.R.cpu(), res.pose.t.cpu())
    gap = float(pose_delta_norm(poses["cuda"], poses["cpu"]))
    # Both runs meet the bounds; their poses may differ by float32 summation
    # order and argmax near-ties in the tree build, well inside the bounds.
    if not gap < 0.01:
        raise CheckFailed(f"cuda and cpu poses differ by {gap}")
    out["pose_delta_cuda_vs_cpu"] = gap
    return out


def run_cli(argv):
    """hgmm_torch.cli.main.main(argv) in process; returns what it printed
    (echoed to stderr)."""
    from hgmm_torch.cli.main import main as cli_main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli_main(argv)
    print(buf.getvalue(), file=sys.stderr, end="", flush=True)
    return buf.getvalue()


def printed_matrix(text: str):
    """The 4x4 matrix numpy printed just before the `final match rmse` line."""
    import numpy as np

    body = text[: text.index("final match rmse")]
    return np.array(body.replace("[", " ").replace("]", " ").split(), np.float32).reshape(4, 4)


def save_pair(torch, work, name, source, target):
    from hgmm_torch.data.ply import save_ply

    paths = [str(work / f"{name}_{side}.ply") for side in ("source", "target")]
    for path, pts in zip(paths, (source, target)):
        save_ply(path, pts.cpu().numpy())
    return paths


def cli_icp(torch, dev, work, errs, timings):
    """`icp` through the CLI on the 437,645-point pair; then the knn kernel
    against its plain version at that size."""
    from hgmm_torch.data.synthetic import make_cloud
    from hgmm_torch.eval.metrics import registration_rmse
    from hgmm_torch.models.se3 import Pose, so3_exp
    from hgmm_torch.ops import fused_em, knn

    target = make_cloud(N_POINTS, "trefoil", seed=4, device=dev)
    gt = Pose(so3_exp(torch.tensor(ICP_OMEGA, device=dev)), torch.tensor(ICP_T, device=dev))
    source = gt.inverse().apply(target)
    src_p, tgt_p = save_pair(torch, work, "icp", source, target)
    torch.cuda.synchronize()
    fused_em.reset_launches()
    t0 = time.perf_counter()
    out = run_cli(["icp", src_p, tgt_p, "--iters", str(ICP_ITERS), "--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(fused_em.LAUNCHES)
    T = torch.from_numpy(printed_matrix(out)).to(dev)
    final_rmse = float(out.split("final match rmse:")[1].split()[0])
    if not (bool(torch.isfinite(T).all()) and final_rmse == final_rmse):
        raise CheckFailed("cli icp: non-finite output")
    rmse = float(registration_rmse(Pose.from_matrix(T), source, gt))
    if not rmse < ICP_RMSE:
        raise CheckFailed(f"cli icp: registration RMSE {rmse} not below {ICP_RMSE}")
    require_launched(counts, "cli_icp")

    # One search at full size, at the identity (the first ICP iteration).
    idx, d2 = knn.nearest_neighbor_cuda(source, target)
    ref_idx, ref_d2 = knn.nearest_neighbor_ref(source, target)
    agree = check_knn(torch, source, target, idx, d2, ref_idx, ref_d2, errs)
    ms = cuda_ms(torch, lambda: knn.nearest_neighbor_cuda(source, target), reps=5, warmup=1)
    plain = cuda_ms(torch, lambda: knn.nearest_neighbor_ref(source, target), reps=2, warmup=1)
    timings["knn"] = [{"nq": N_POINTS, "nt": N_POINTS, "ms": ms, "plain_ms": plain,
                       "headline": True}]
    log({"phase": "cli_icp", "n_source": N_POINTS, "n_target": N_POINTS, "iters": ICP_ITERS,
         "wall_s": wall,
         "registration_rmse": rmse, "bound": ICP_RMSE, "final_match_rmse": final_rmse,
         "launches": counts, "knn_index_agreement": agree, "knn_ms": ms, "knn_plain_ms": plain})
    return counts


def cli_fit_tree(torch, work):
    """`fit-gmm --tree` to an npz and back through load_tree."""
    from hgmm_torch.data.ply import save_ply
    from hgmm_torch.data.synthetic import make_cloud_np
    from hgmm_torch.utils.checkpoint import load_tree

    cloud_p, tree_p = work / "fit_target.ply", work / "tree.npz"
    save_ply(cloud_p, make_cloud_np(N_POINTS, "trefoil", seed=4))
    t0 = time.perf_counter()
    run_cli(["fit-gmm", str(cloud_p), "--tree", "--out", str(tree_p), "--device", "cuda"])
    wall = time.perf_counter() - t0
    tree = load_tree(tree_p)
    sizes = [int(lvl.pi.shape[0]) for lvl in tree.levels]
    if sizes != [8, 64, 512] or tree.branch != 8:
        raise CheckFailed(f"cli fit-gmm --tree: levels {sizes}, branch {tree.branch}")
    if not all(bool(torch.isfinite(x).all()) for lvl in tree.levels for x in lvl):
        raise CheckFailed("cli fit-gmm --tree: non-finite parameters")
    log({"phase": "cli_fit_tree", "wall_s": wall, "levels": sizes, "file": tree_p.name})


def cli_register_config3(torch, dev, work, errs, timings):
    """`register --preset config3_mahalanobis` on the config-2 pair; then the
    K=512 reg_stats with top_k=8 at the final pose against its plain version."""
    import numpy as np

    from hgmm_torch.configs.presets import PRESETS
    from hgmm_torch.models.se3 import Pose
    from hgmm_torch.ops import em_ref, fused_em, prepare
    from hgmm_torch.pipelines.register import model_terms
    from hgmm_torch.utils.checkpoint import load_tree

    p3 = PRESETS["config3_mahalanobis"]
    source, target, gt = make_pair(torch, N_POINTS, dev)
    src_p, tgt_p = save_pair(torch, work, "config3", source, target)
    out_p = work / "config3_T.npy"
    torch.cuda.synchronize()
    fused_em.reset_launches()
    t0 = time.perf_counter()
    run_cli(["register", src_p, tgt_p, "--preset", p3.name, "--out", str(out_p), "--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(fused_em.LAUNCHES)
    T = torch.from_numpy(np.load(out_p)).to(dev)
    if not bool(torch.isfinite(T).all()):
        raise CheckFailed("cli register config3: non-finite transform")

    final = Pose.from_matrix(T)
    errors = pose_errors(source, final, gt)
    for key, bound in BOUNDS.items():
        if not errors[key] < bound:
            raise CheckFailed(f"cli register config3: {key} = {errors[key]} not below {bound}")
    require_launched(counts, "cli_register_config3")

    # The gated kernel at the leaves (config 3 takes no cut) of the tree the
    # CLI fits with the same seed and sweeps (tree.npz), at the final pose.
    W, mu, A6, b3 = model_terms(load_tree(work / "tree.npz", device=dev).leaf_mixture())
    pose = (final.R.contiguous(), final.t.contiguous())
    # The fitted leaves are narrow, so their logits are sums of large terms
    # that cancel, and more points sit within rounding of their gate.
    share = check_reg_top_k(torch, source, None, W, mu, A6, b3, pose, p3.top_k, p3.outlier_logit,
                            errs, max_share=0.05)
    src = prepare(source)
    k = W.shape[1]
    for top_k in (p3.top_k, None):
        tab = fused_em.reg_tables(src.pts4, W, mu, A6, b3, top_k, p3.outlier_logit)
        pose12 = torch.cat([pose[0].reshape(9), pose[1]]).contiguous()
        timings["reg_stats"].append({
            "k": k, "n": N_POINTS, "top_k": top_k, "outlier_logit": p3.outlier_logit,
            "ms": cuda_ms(torch, lambda: fused_em.reg_partials(tab, pose12)),
            "wrapper_ms": cuda_ms(torch, lambda: fused_em.reg_stats(src.pts4, W, mu, A6, b3, pose, top_k,
                                                                    p3.outlier_logit)),
            "plain_ms": cuda_ms(torch, lambda: em_ref.reg_stats(source, W, mu, A6, b3, pose, None,
                                                                top_k, p3.outlier_logit), reps=5),
            "headline": False})
    log({"phase": "cli_register_config3", "n_source": N_POINTS, "n_target": N_POINTS,
         "wall_s": wall, "errors": errors, "bounds": BOUNDS, "launches": counts,
         "top_k_near_tie_share": share, "reg_stats_top_k": timings["reg_stats"][-2:]})
    return counts


def check_f64(torch, name, got, ref, ref64, n, metric_errs) -> dict:
    """At metric scale, where the kernel and its twin round the expanded
    quadratic form differently: for each field, the kernel's largest gap to
    the float64 direct form must be within the strict tolerance of that
    float64 value (TOL_EM / TOL_REG, atol scaled by n / 300), widened by
    F64_FACTOR times the twin's own largest gap. Returns the gaps."""
    tol = {"S": (TOL_EM["rtol"], TOL_EM["atol"]), "loglik": (TOL_EM["ll_rtol"], 0.0),
           **{f: TOL_REG[f] for f in ("horn", "A", "b")}}
    out = {}
    for f in got._fields:
        g, r, e = (getattr(v, f).double().cpu() for v in (got, ref, ref64))
        if not bool(torch.isfinite(g).all()):
            raise CheckFailed(f"{name}.{f}: non-finite kernel output")
        kern, twin = float((g - e).abs().max()), float((r - e).abs().max())
        rtol, atol = tol[f]
        limit = F64_FACTOR * twin + atol * n / 300.0 + rtol * float(e.abs().max())
        if not kern <= limit:
            raise CheckFailed(f"{name}.{f}: kernel {kern} from float64, above {limit} "
                              f"(strict tolerance + {F64_FACTOR} x the twin's {twin})")
        out[f] = {"kernel_vs_f64": kern, "twin_vs_f64": twin,
                  "kernel_vs_twin": float((g - r).abs().max()), "f64_max_abs": float(e.abs().max())}
        metric_errs[name] = max(metric_errs.get(name, 0.0), out[f]["kernel_vs_twin"])
    return out


def lidar_checks(torch, dev, errs, metric_errs):
    """em_stats (flat, weighted; outlier none and -8), em_step on its
    statistics, em_stats_masked, assign and reg_stats (wls terms, outlier -8)
    on LiDAR-like inputs: covariances
    with a 0.02 m minor axis, 30 % zero-weight rows at the origin, N = the
    odometry bucket. At LIDAR_EXTENT (+-40 m) the kernel is held against the
    float64 direct form relative to its twin (check_f64); at
    LIDAR_STRICT_EXTENT, against its twin within the strict tolerances."""
    from hgmm_torch.data.synthetic import lidar_mixture_np, lidar_points_np
    from hgmm_torch.models.gmm import scene_variance
    from hgmm_torch.models.se3 import so3_exp
    from hgmm_torch.ops import em_ref, fused_em, prepare
    from hgmm_torch.ops.gaussians import MixtureParams, pack_loglik_weights, precision_terms, sym_pack

    n = ODO_BUCKET
    report = {}
    for extent in (LIDAR_EXTENT, LIDAR_STRICT_EXTENT):
        strict = extent == LIDAR_STRICT_EXTENT
        for k in (8, 64, 512):
            mix = lidar_mixture_np(k, seed=k, extent=extent)
            pts_np, w_np = lidar_points_np(n, mix, seed=k + 1, extent=extent)
            params = MixtureParams(*(torch.from_numpy(a).to(dev) for a in mix))
            pts, w = torch.from_numpy(pts_np).to(dev), torch.from_numpy(w_np).to(dev)
            n_live = int((w > 0).sum())
            W = pack_loglik_weights(params)
            prep = prepare(pts, w)
            rec = {}

            def hold(kernel, label, got, ref, ref64, nn):
                if strict and kernel == "reg_stats":
                    check_reg(torch, got, ref, nn, errs)
                elif strict:
                    check_em(torch, kernel, got, ref, nn, errs)
                rec[label] = check_f64(torch, kernel, got, ref, ref64, nn, metric_errs)

            for outlier in (None, -8.0):
                hold("em_stats", f"em_stats_outlier_{outlier}", fused_em.em_stats(prep.pts4, W, outlier),
                     em_ref.em_stats(pts, W, w, outlier),
                     em_ref.em_stats_direct(pts, params, w, outlier), n)
            # The M-step of a sweep on these points (the body's partial rows).
            rec["em_step"] = em_step_check(torch, f"{extent:g}m K{k}", params,
                                           fused_em.em_partials(prep.pts4, W), w.sum(),
                                           1e-4 * scene_variance(pts, w), metric_errs)
            if k > 8:
                coarse = MixtureParams(torch.full((k // 8,), 8.0 / k, device=dev),
                                       params.mu[::8].contiguous(), 4.0 * params.sigma[::8].contiguous())
                parent = em_ref.assign(pts, pack_loglik_weights(coarse))
                hold("em_stats_masked", "em_stats_masked",
                     fused_em.em_stats_masked(prep.pts4, W, parent, 8),
                     em_ref.em_stats_masked(pts, W, parent, 8, w),
                     em_ref.em_stats_direct(pts, params, w, None, parent, 8), n)
                check_assign(torch, fused_em.assign(prep.pts4, W, parent, 8),
                             em_ref.assign(pts, W, parent, 8), pts, W, parent, 8, errs,
                             rel=0.0 if strict else LIDAR_TIE_REL)
            got = fused_em.assign(prep.pts4, W)
            check_assign(torch, got, em_ref.assign(pts, W), pts, W, None, None, errs,
                         rel=0.0 if strict else LIDAR_TIE_REL)
            rec["assign_disagrees_with_f64"] = float(
                (got.long() != em_ref.direct_logits(pts, params).argmax(1)).double().mean())
            A, b, _ = precision_terms(params)
            pose = (so3_exp(torch.tensor([0.0, 0.0, 0.05], device=dev)),
                    torch.tensor([0.3, -0.1, 0.02], device=dev))
            hold("reg_stats", "reg_stats_outlier_-8",
                 fused_em.reg_stats(prep.pts4, W, params.mu, sym_pack(A), b, pose, None, -8.0),
                 em_ref.reg_stats(pts, W, params.mu, sym_pack(A), b, pose, w, None, -8.0),
                 em_ref.reg_stats_direct(pts, params, pose, w, -8.0), n_live)
            report[f"{extent:g}m_K{k}"] = rec
    torch.cuda.synchronize()
    return report


@contextlib.contextmanager
def clocked(torch, module, name, spans):
    """Within the block, module.name records the seconds of each call (to
    the device's end) in spans[name]: the CLI's own calls, first ones in the
    process included."""
    fn = getattr(module, name)

    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        spans.setdefault(name, []).append(time.perf_counter() - t0)
        return out

    setattr(module, name, wrapper)
    try:
        yield
    finally:
        setattr(module, name, fn)


def parse_ate(out: str) -> float:
    return float(out.split("ATE vs ground truth:")[1].split("m")[0])


def cli_odometry(torch, dev, work, errs, metric_errs, timings):
    """The odometry path through the CLI on a synthetic KITTI-format loop of
    SEQ_FRAMES scans of SEQ_POINTS points (config 4: tree, voxel 0.3, bucket
    16,384, 10 sweeps, 30 iterations, outlier -8): run 1 dead-reckons with a
    checkpoint; run 2 resumes it, detects loop closures, refines and builds
    the map; `localize` then relocalizes frame 0 against the map. Each
    command runs with the launch counters at 0. Then times a pair's fit and
    registration apart, profiles one pair, times refinement and the map
    build, and checks and times the kernels at the odometry shapes."""
    import ast

    import numpy as np

    from hgmm_torch.data import native
    from hgmm_torch.data.kitti import load_velodyne_bin, sequence_scan_paths, voxel_downsample
    from hgmm_torch.eval.metrics import rotation_error_deg
    from hgmm_torch.models.se3 import Pose
    from hgmm_torch.ops import fused_em
    from hgmm_torch.pipelines import loop_closure, mapping, odometry
    from hgmm_torch.pipelines.pose_graph import EdgeList
    from hgmm_torch.utils import checkpoint as ckpt

    seq = work / "seq"
    t0 = time.perf_counter()
    write_lidar_sequence(seq)
    write_s = time.perf_counter() - t0
    md5 = {f: hashlib.md5((seq / f).read_bytes()).hexdigest() for f in SEQ_MD5}
    if md5 != SEQ_MD5:
        raise CheckFailed(
            f"odometry sequence: md5 {md5}, but JAX_CLI_DEAD_ATE was measured on {SEQ_MD5}; "
            f"re-measure it with the JAX CLI on the new sequence (PERF.md section 4: "
            f"python -m hgmm.cli.main --platform cpu odometry SEQ --poses SEQ/poses.txt) "
            f"and update JAX_CLI_DEAD_ATE and SEQ_MD5")
    t0 = time.perf_counter()
    native_lib = native.build(verbose=False)  # the commands read and voxelize through it
    native_build_s = time.perf_counter() - t0
    ck, metrics, map_p, loc_p = (work / f for f in ("odo_ck.npz", "odo.jsonl", "map.npz", "loc.npy"))
    for f in (ck, metrics, map_p, loc_p):  # a run before in this checkout would be resumed
        f.unlink(missing_ok=True)
    base = ["odometry", str(seq), "--poses", str(seq / "poses.txt"), "--checkpoint", str(ck),
            "--metrics", str(metrics), "--out", str(work / "traj.npy"), "--device", "cuda"]
    counts, walls, outs, spans, native_calls = {}, {}, {}, {}, {}
    for name, argv in (
        ("cli_odometry", base),
        ("cli_odometry_closures", base + ["--detect-closures", "--refine", "--map", str(map_p)]),
        ("cli_localize", ["localize", str(seq / "velodyne" / "000000.bin"), str(map_p),
                          "--out", str(loc_p), "--device", "cuda"]),
    ):
        torch.cuda.synchronize()
        fused_em.reset_launches()
        t0 = time.perf_counter()
        reads, voxels = [], []
        with clocked(torch, loop_closure, "detect_loop_closures", spans), \
                clocked(torch, odometry, "refine_odometry", spans), \
                clocked(torch, mapping, "build_map", spans), \
                spied(native, "load_kitti_bin", reads), spied(native, "voxel_downsample", voxels):
            outs[name] = run_cli(argv)
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
        counts[name] = dict(fused_em.LAUNCHES)
        require_launched(counts[name], name)
        native_calls[name] = {"load_kitti_bin": len(reads), "voxel_downsample": len(voxels)}
    for name in ("cli_odometry", "cli_odometry_closures"):
        if not all(native_calls[name].values()):
            raise CheckFailed(f"{name}: the scans were not read and voxelized through the native "
                              f"reader: {native_calls[name]}")

    dead = parse_ate(outs["cli_odometry"])
    refined = parse_ate(outs["cli_odometry_closures"])
    chain_s = float(outs["cli_odometry"].split(" poses in ")[1].split("s")[0])
    closure_s = float(outs["cli_odometry_closures"].split(" poses in ")[1].split("s")[0])
    if "loop closures accepted:" not in outs["cli_odometry_closures"]:
        raise CheckFailed("cli odometry: no loop closure accepted")
    pairs = ast.literal_eval(outs["cli_odometry_closures"].split("loop closures accepted:")[1]
                             .splitlines()[0].strip())
    if not any(j - i > 5 for i, j in pairs):
        raise CheckFailed(f"cli odometry: no accepted closure with j - i > 5: {pairs}")
    ate_bound = ODO_ATE_FACTOR * JAX_CLI_DEAD_ATE + ODO_ATE_SLACK
    if not (dead == dead and refined == refined):
        raise CheckFailed("cli odometry: non-finite ATE")
    if not dead <= ate_bound:
        raise CheckFailed(f"cli odometry: dead-reckoned ATE {dead} above {ate_bound} "
                          f"({ODO_ATE_FACTOR} x the JAX CLI's {JAX_CLI_DEAD_ATE} + {ODO_ATE_SLACK})")
    if not refined < dead:
        raise CheckFailed(f"cli odometry: refined ATE {refined} not below dead-reckoned {dead}")
    for f in ("traj.npy",):
        if not np.isfinite(np.load(work / f)).all():
            raise CheckFailed(f"cli odometry: non-finite {f}")
    T = np.load(loc_p)
    loc = Pose.from_matrix(torch.from_numpy(T.astype(np.float32)))
    loc_t = float(np.linalg.norm(T[:3, 3]))
    loc_deg = float(rotation_error_deg(loc, Pose.identity()))
    if not (np.isfinite(T).all() and loc_t < LOC_TRANS and loc_deg < LOC_DEG):
        raise CheckFailed(f"cli localize: |t| = {loc_t} m, rotation {loc_deg} deg "
                          f"(bounds {LOC_TRANS} m, {LOC_DEG} deg)")
    tree = ckpt.load_tree(map_p, device=dev)
    if not all(bool(torch.isfinite(x).all()) for lvl in tree.levels for x in lvl):
        raise CheckFailed("cli odometry --map: non-finite map parameters")
    localize_s = float(outs["cli_localize"].split(" in ")[1].split("s;")[0])

    # One pair (frames 0 -> 1) as the chain runs it: the fit and the
    # registration timed apart, then one pair under the profiler.
    cfg = odometry.OdometryConfig(voxel=0.3, device=dev)
    paths = sequence_scan_paths(seq)
    rng = np.random.default_rng(cfg.seed)
    frames = [odometry._bucketize(voxel_downsample(load_velodyne_bin(p), cfg.voxel), cfg.bucket, rng)
              for p in paths[:2]]
    ident = Pose.identity(device=dev)

    def timed(fn, reps=3):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) / reps

    model, fit_s = timed(lambda: odometry._fit_frame_model(frames[0], cfg, odometry.frame_generator(0, 0)))
    res, reg_s = timed(lambda: odometry._register_to_model(model, frames[1], cfg, ident))
    pair = profiled(torch, lambda: odometry._register_frames(
        frames[0], frames[1], cfg, odometry.frame_generator(0, 0), ident), work / "trace")

    # Refinement and the map build, timed on the run's chain and closures.
    start, rel, ab, lls = ckpt.load_odometry(ck, device=dev)
    chain = odometry.OdometryResult(abs_poses=ab, rel_poses=rel, logliks=lls)
    closures = EdgeList(torch.tensor([p[0] for p in pairs], device=dev),
                        torch.tensor([p[1] for p in pairs], device=dev),
                        torch.stack([ab[i].inverse().compose(ab[j]).R for i, j in pairs]),
                        torch.stack([ab[i].inverse().compose(ab[j]).t for i, j in pairs]),
                        torch.full((len(pairs),), 10.0, device=dev))
    graph, refine_s = timed(lambda: odometry.refine_odometry(chain, loop_closures=closures))
    scans = [load_velodyne_bin(p) for p in paths]
    _, map_s = timed(lambda: mapping.build_map(scans, graph.poses(), mapping.MapConfig(voxel=0.3)),
                     reps=1)

    log({"phase": "cli_odometry", "frames": SEQ_FRAMES, "points_per_scan": SEQ_POINTS,
         "bucket": cfg.bucket, "write_sequence_s": write_s, "sequence_md5": md5,
         "ate_dead_reckoned_m": dead, "ate_refined_m": refined, "ate_bound_m": ate_bound,
         "jax_cli_dead_ate_m": JAX_CLI_DEAD_ATE, "closures": pairs,
         "localize_t_m": loc_t, "localize_rot_deg": loc_deg,
         "chain_s": chain_s, "closure_s": closure_s, "refine_s": refine_s, "map_s": map_s,
         "cli_spans_s": spans,
         "localize_s": localize_s, "cli_wall_s": walls, "launches": counts,
         "native_library": native_lib.name, "native_build_s": native_build_s,
         "native_calls": native_calls,
         "pair": {"fit_s": fit_s, "register_s": reg_s, "live_iterations":
                  int((res.deltas >= 1e-7).sum()), **pair}})
    odometry_shapes(torch, dev, frames, model, res.pose, errs, metric_errs, timings)
    return counts


def odometry_shapes(torch, dev, frames, tree, pose, errs, metric_errs, timings):
    """Each kernel at the odometry shapes, held to its twin within the strict
    tolerances (check_em / check_reg / check_assign) and to the float64
    direct form (check_f64), and timed: frame 0's bucket (16,384 of its
    voxels: every scan of the sequence voxelizes to more than the bucket)
    and its fitted tree (K = 8 / 64 / 512), frame 1 registered with outlier
    -8; em_step on each level's body rows (em_step_check: the plain rows at
    K = 8, the rows of the level's real parent grouping at K = 64 and 512).
    The checks run again on both buckets with their last quarter made
    zero-weight rows at the origin, the padding _bucketize gives a scan of
    12,288 voxels."""
    import collections

    import numpy as np

    from hgmm_torch.models.gmm import scene_variance
    from hgmm_torch.ops import em_ref, fused_em, prepare
    from hgmm_torch.ops.gaussians import pack_loglik_weights
    from hgmm_torch.pipelines.register import model_terms

    def padded(frame):
        pts, w = frame
        keep = 3 * pts.shape[0] // 4
        return (np.concatenate([pts[:keep], np.zeros_like(pts[keep:])]),
                np.concatenate([w[:keep], np.zeros_like(w[keep:])]))

    Ws = [pack_loglik_weights(p) for p in tree.levels]
    p = (pose.R.contiguous(), pose.t.contiguous())
    gaps, strict = {}, collections.defaultdict(float)
    for tag, pair in (("", frames[:2]), ("_padded", [padded(f) for f in frames[:2]])):
        tgt, tw = (torch.from_numpy(a).to(dev) for a in pair[0])
        src, sw = (torch.from_numpy(a).to(dev) for a in pair[1])
        tp, sp = prepare(tgt, tw), prepare(src, sw)
        n, n_live = tgt.shape[0], int((sw > 0).sum())
        parents = [None, fused_em.assign(tp.pts4, Ws[0])]
        parents.append(fused_em.assign(tp.pts4, Ws[1], parents[1], 8))

        def record(name, k, kern, plain, **extra):
            if not tag:
                timings[name].append({"k": k, "n": n, "odometry": True,
                                      "masked": name in ("em_stats_masked", "assign") and k > 8,
                                      "ms": device_ms(torch, kern), "call_ms": cuda_ms(torch, kern),
                                      "plain_ms": cuda_ms(torch, plain, reps=5), "headline": False,
                                      **{key: f() for key, f in extra.items()}})

        def hold_em(name, key, got, ref, ref64):
            check_em(torch, name, got, ref, n, strict)
            gaps[key + tag] = check_f64(torch, name, got, ref, ref64, n, metric_errs)

        W0, lvl0 = Ws[0], tree.levels[0]
        hold_em("em_stats", "em_stats_K8", fused_em.em_stats(tp.pts4, W0),
                em_ref.em_stats(tgt, W0, tw), em_ref.em_stats_direct(tgt, lvl0, tw))
        record("em_stats", 8, lambda: fused_em.em_stats(tp.pts4, W0), lambda: em_ref.em_stats(tgt, W0, tw))
        for lvl in (0, 1, 2):
            W, par = Ws[lvl], parents[lvl]
            br = None if par is None else 8
            check_assign(torch, fused_em.assign(tp.pts4, W, par, br), em_ref.assign(tgt, W, par, br),
                         tgt, W, par, br, errs, rel=LIDAR_TIE_REL)
            record("assign", W.shape[1], lambda: fused_em.assign(tp.pts4, W, par, br),
                   lambda: em_ref.assign(tgt, W, par, br))
            if par is not None:
                hold_em("em_stats_masked", f"em_stats_masked_K{W.shape[1]}",
                        fused_em.em_stats_masked(tp.pts4, W, par, 8),
                        em_ref.em_stats_masked(tgt, W, par, 8, tw),
                        em_ref.em_stats_direct(tgt, tree.levels[lvl], tw, None, par, 8))
                groups = fused_em.group_by_parent(tp.pts4, par, 8, W.shape[1])
                record("em_stats_masked", W.shape[1], lambda: fused_em.em_stats_grouped(groups, W),
                       lambda: em_ref.em_stats_masked(tgt, W, par, 8, tw),
                       wrapper_ms=lambda: cuda_ms(torch, lambda: fused_em.em_stats_masked(tp.pts4, W, par, 8)),
                       chunks=lambda: groups.n_chunks, chunk_points=lambda: groups.chunk_points)
            parts = (fused_em.em_partials(tp.pts4, W) if par is None
                     else fused_em.em_partials_grouped(groups, W))
            gaps[f"em_step_K{W.shape[1]}{tag}"] = em_step_check(
                torch, f"odometry K{W.shape[1]}{tag}", tree.levels[lvl], parts, tw.sum(),
                1e-4 * scene_variance(tgt, tw), metric_errs)
        for params in tree.levels:
            W, mu, A6, b3 = model_terms(params)
            k = W.shape[1]
            got = fused_em.reg_stats(sp.pts4, W, mu, A6, b3, p, None, -8.0)
            ref = em_ref.reg_stats(src, W, mu, A6, b3, p, sw, None, -8.0)
            # The frames reach +-40 m: reg_stats is held to float64 there, as in
            # lidar_checks, and to its twin at LIDAR_STRICT_EXTENT (ROADMAP Queue
            # 3, "Float32 range"); its gap to the twin is recorded.
            gaps[f"reg_stats_K{k}{tag}"] = g = check_f64(
                torch, "reg_stats", got, ref, em_ref.reg_stats_direct(src, params, p, sw, -8.0),
                n_live, metric_errs)
            strict["reg_stats_vs_twin"] = max(strict["reg_stats_vs_twin"],
                                              *(v["kernel_vs_twin"] for v in g.values()))
            tab = fused_em.reg_tables(sp.pts4, W, mu, A6, b3, None, -8.0)
            pose12 = torch.cat([p[0].reshape(9), p[1]]).contiguous()
            record("reg_stats", k, lambda: fused_em.reg_partials(tab, pose12),
                   lambda: em_ref.reg_stats(src, W, mu, A6, b3, p, sw, None, -8.0),
                   wrapper_ms=lambda: cuda_ms(torch, lambda: fused_em.reg_stats(sp.pts4, W, mu, A6, b3, p,
                                                                                 None, -8.0)),
                   lanes=lambda: tab.plan.lanes, blocks=lambda: tab.plan.blocks)
    log({"phase": "odometry_kernels", "strict_max_abs_err": strict, "gaps": gaps,
         "timings": {k: [t for t in v if t.get("odometry")] for k, v in timings.items()}})


# --------------------------------------------------------------------------
# the sharded path (hgmm_torch.parallel)


@contextlib.contextmanager
def spied(module, name, calls):
    """Within the block, module.name records each call's arguments in
    calls (and runs as before)."""
    fn = getattr(module, name)

    def wrapper(*args, **kwargs):
        calls.append((args, kwargs))
        return fn(*args, **kwargs)

    setattr(module, name, wrapper)
    try:
        yield
    finally:
        setattr(module, name, fn)


def nccl_calls(trace_json: Path, sweeps: int) -> dict:
    """The all-reduce in a profiler trace: the NCCL kernels (names, launches,
    device µs a launch, launches a sweep; at world size 1 an in-place sum
    launches none) and the host ops of the call (name: calls a sweep, host µs
    a call)."""
    events = [e for e in json.loads(trace_json.read_text())["traceEvents"] if "dur" in e]
    kernels = [e for e in events if e.get("cat") == "kernel" and "nccl" in e.get("name", "").lower()]
    us = [e["dur"] for e in kernels]
    host = {}
    for e in events:
        name = e.get("name", "")
        if e.get("cat") == "cpu_op" and ("allreduce" in name.lower() or "all_reduce" in name.lower()):
            host.setdefault(name[:60], []).append(e["dur"])
    return {"kernels": sorted({e["name"][:80] for e in kernels}), "launches": len(us),
            "launches_per_sweep": len(us) / sweeps,
            "device_us_per_call": (sum(us) / len(us)) if us else None,
            "host_ops": {name: {"calls_per_sweep": len(v) / sweeps, "host_us_per_call": sum(v) / len(v)}
                         for name, v in host.items()}}


def config5_check(torch, dev, mesh, work) -> dict:
    """(a) Config 5 at full width over NCCL: benchmarks/large_n.py's scene
    (SHARD_N points round 256 centres, K = 512, SHARD_SWEEPS sweeps) through
    sharded_em_fit and the unsharded em_fit from one init: the per-sweep
    loglik within FIT_LL_RTOL, the parameters within tests/test_parallel.py's
    tolerances; ms a sweep of both (host clock to the device's end); the
    sharded sweeps under torch's sync debug mode "error"; the NCCL kernels
    by the profiler."""
    from hgmm_torch import ops
    from hgmm_torch.benchmarks.large_n import scene
    from hgmm_torch.models.gmm import em_fit, em_sweeps, init_params
    from hgmm_torch.ops import fused_em
    from hgmm_torch.parallel import sharded_em_fit
    from hgmm_torch.parallel.sharded import _mesh_scalars
    from hgmm_torch.utils.profiling import trace

    pts = torch.from_numpy(scene(SHARD_N)).to(dev)
    init = init_params(pts, SHARD_K, torch.Generator().manual_seed(1))
    out = {"n": SHARD_N, "k": SHARD_K, "sweeps": SHARD_SWEEPS}
    runs = {}
    for name, fn in (("unsharded", lambda: em_fit(pts, init, n_iters=SHARD_SWEEPS)),
                     ("sharded", lambda: sharded_em_fit(pts, init, mesh, n_iters=SHARD_SWEEPS))):
        fn()
        torch.cuda.synchronize()
        fused_em.reset_launches()
        t0 = time.perf_counter()
        runs[name] = fn()
        torch.cuda.synchronize()
        out[f"{name}_ms_per_sweep"] = 1e3 * (time.perf_counter() - t0) / SHARD_SWEEPS
        out[f"{name}_launches"] = {k: v for k, v in fused_em.LAUNCHES.items() if v}
    counts = dict(out["sharded_launches"])
    (p1, ll1), (p0, ll0) = runs["sharded"], runs["unsharded"]
    gaps = ((ll1.double() - ll0.double()).abs() / ll0.double().abs()).cpu()
    if not bool((gaps <= FIT_LL_RTOL).all()):
        raise CheckFailed(f"config 5: sharded per-sweep logliks off the unsharded by {gaps.tolist()}")
    tol = {"pi": (1e-4, 1e-6), "mu": (1e-4, 1e-5), "sigma": (1e-3, 1e-5)}
    out["param_max_abs_gap"] = {key: close(torch, f"config 5 sharded {key}", getattr(p1, key),
                                           getattr(p0, key), *tol[key]) for key in tol}
    out["loglik_max_relative_gap"] = float(gaps.max())
    out["final_loglik_per_point"] = float(ll1[-1]) / SHARD_N
    # The sharded sweeps alone: no host sync; the NCCL kernels by the profiler.
    prep = ops.prepare(pts)
    total, floor = _mesh_scalars(prep, mesh, 1e-4)
    em_sweeps(prep, init, 2, total, floor, mesh=mesh)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        em_sweeps(prep, init, SHARD_SWEEPS, total, floor, mesh=mesh)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    d = work / "shard_trace"
    with trace(d):
        em_sweeps(prep, init, SHARD_SWEEPS, total, floor, mesh=mesh)
        torch.cuda.synchronize()
    out["host_syncs_in_sweeps"] = 0
    out["all_reduce"] = nccl_calls(d / "trace.json", SHARD_SWEEPS)
    shutil.rmtree(d, ignore_errors=True)
    out["memory_peak_gb"] = torch.cuda.max_memory_allocated() / 2**30
    del pts, prep
    return out, counts


def level_logliks(torch, tree, points) -> list:
    """Each level's per-point loglik of the points under its mixture."""
    from hgmm_torch.models.gmm import log_likelihood

    return [float(log_likelihood(lvl, points)) for lvl in tree.levels]


def sharded_pair(torch, mesh, source, target, gt):
    """sharded_tree_fit then sharded_register_tree on the config-2 pair, as
    register_pair runs it (config2_tree_8x3)."""
    from hgmm_torch.parallel import sharded_register_tree, sharded_tree_fit

    kw = preset_kwargs()
    tree = sharded_tree_fit(target, mesh, branch=kw["branch"], levels=kw["levels"],
                            em_iters=kw["fit_iters"], generator=torch.Generator().manual_seed(0))
    res = sharded_register_tree(source, tree, mesh, complexity_threshold=kw["complexity_threshold"],
                                n_iters=kw["n_iters"], method=kw["method"], top_k=kw["top_k"],
                                outlier_logit=kw["outlier_logit"])
    return tree, res


def check_pair(torch, name, source, res, gt, ref_pose) -> dict:
    finite = all(bool(torch.isfinite(x).all()) for x in (res.pose.R, res.pose.t, res.logliks, res.deltas))
    if not finite:
        raise CheckFailed(f"{name}: non-finite output")
    errors = pose_errors(source, res.pose, gt)
    vs_pair = pose_errors(source, res.pose, ref_pose)
    for key, bound in BOUNDS.items():
        if not (errors[key] < bound and vs_pair[key] < bound):
            raise CheckFailed(f"{name}: {key} = {errors[key]} (to the truth), {vs_pair[key]} (to "
                              f"register_pair's pose), not below {bound}")
    return {"errors": errors, "vs_register_pair": vs_pair, "converged": bool(res.converged)}


def sharded_phase(torch, dev, mesh, work, pair_syncs: dict) -> tuple:
    """(a) config5_check; (b) the config-2 pair through sharded_tree_fit and
    sharded_register_tree over NCCL at world size 1: the pose bounds of
    tests/test_register.py, register_pair's pose within them, and the pair's
    kernels, copies and host syncs (profiled: no sync where register_pair,
    pair_syncs (pair_accounting's record), has none); (c) the same pair on SHARD_RANKS emulated ranks on the card
    (parallel.EmulatedMesh: rank-dependent groupings by parent, sums in rank
    order, on the real kernels): the same bounds, each level's per-point
    loglik within FIT_LL_RTOL of (b)'s. Returns the phase's record and the
    launches of its sharded runs (each run with the counters at 0, summed)."""
    import hgmm_torch
    from hgmm_torch.ops import fused_em
    from hgmm_torch.parallel import EmulatedMesh

    t_start = time.perf_counter()
    counts = {name: 0 for name in fused_em.LAUNCHES}

    def add(c):
        for key, v in c.items():
            counts[key] += v

    out = {"world_size": mesh.size, "backend": str(torch.distributed.get_backend())}
    out["config5"], c = config5_check(torch, dev, mesh, work)
    add(c)
    source, target, gt = make_pair(torch, N_POINTS, dev)
    ref = hgmm_torch.register_pair(source, target=target, generator=torch.Generator().manual_seed(0),
                                   **preset_kwargs())
    runs = {}
    for name, m in (("nccl_ws1", mesh), (f"emulated_{SHARD_RANKS}", EmulatedMesh(SHARD_RANKS, dev))):
        torch.cuda.synchronize()
        fused_em.reset_launches()
        t0 = time.perf_counter()
        tree, res = sharded_pair(torch, m, source, target, gt)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        add(fused_em.LAUNCHES)
        runs[name] = tree
        out[name] = {"ranks": m.size, "wall_s": wall, "level_logliks": level_logliks(torch, tree, target),
                     **check_pair(torch, f"sharded pair {name}", source, res, gt, ref.pose)}
    a, b = out["nccl_ws1"]["level_logliks"], out[f"emulated_{SHARD_RANKS}"]["level_logliks"]
    gaps = [abs(x - y) / abs(x) for x, y in zip(a, b)]
    if not all(g <= FIT_LL_RTOL for g in gaps):
        raise CheckFailed(f"sharded pair: {SHARD_RANKS} emulated ranks' level logliks {b} off world "
                          f"size 1's {a} by {gaps}")
    out["level_loglik_relative_gaps"] = gaps
    acct = profiled(torch, lambda: sharded_pair(torch, mesh, source, target, gt), work / "shard_pair_trace")
    # No sync of the sharded pair where register_pair has none, and none more
    # at a site (register_pair's count also holds the first switch of torch's
    # sync debug mode in the process, a line of torch's own __init__.py).
    ref_sites = dict(pair_syncs["host_sync_sites"])
    extra = {site: n for site, n in acct["host_sync_sites"] if n > ref_sites.get(site, 0)}
    if extra or acct["host_syncs"] > pair_syncs["host_syncs"]:
        raise CheckFailed(f"sharded pair: {acct['host_syncs']} host syncs, register_pair has "
                          f"{pair_syncs['host_syncs']}: more at {extra}")
    out["pair_accounting"] = acct
    out["register_pair_host_syncs"] = pair_syncs["host_syncs"]
    out["register_pair_host_sync_sites"] = pair_syncs["host_sync_sites"]
    out["seconds"] = time.perf_counter() - t_start
    require_launched(counts, "shard")
    return out, counts


def sharded_cli(torch, dev, mesh, work, seq) -> tuple:
    """(d) The CLI with --sharded over NCCL at world size 1 on the odometry
    sequence, as cli_odometry runs it unsharded: `odometry --sharded` with a
    checkpoint (dead reckoning), then resumed with --detect-closures --refine
    --map, then `localize --sharded` of frame 0 against that map, each with
    the counters at 0 and held to cli_odometry's bounds. (e) refine_chain_
    sharded on that run's chain and closures (the arguments of its
    refine_odometry call), at world size 1 and on SHARD_RANKS emulated ranks,
    against the dense refine_pose_graph within tests/test_pose_graph.py's
    sharded-vs-dense tolerance (PG_ATOL)."""
    import ast

    import numpy as np

    from hgmm_torch.eval.metrics import rotation_error_deg
    from hgmm_torch.models.se3 import Pose
    from hgmm_torch.ops import fused_em
    from hgmm_torch.pipelines import odometry

    t_start = time.perf_counter()
    ck, map_p, loc_p = (work / f for f in ("shard_ck.npz", "shard_map.npz", "shard_loc.npy"))
    for f in (ck, map_p, loc_p):
        f.unlink(missing_ok=True)
    base = ["odometry", str(seq), "--poses", str(seq / "poses.txt"), "--checkpoint", str(ck),
            "--out", str(work / "shard_traj.npy"), "--sharded", "--device", "cuda"]
    counts, walls, outs, calls = {}, {}, {}, []
    for name, argv in (
        ("cli_odometry_sharded", base),
        ("cli_odometry_closures_sharded", base + ["--detect-closures", "--refine", "--map", str(map_p)]),
        ("cli_localize_sharded", ["localize", str(seq / "velodyne" / "000000.bin"), str(map_p),
                                  "--out", str(loc_p), "--sharded", "--device", "cuda"]),
    ):
        torch.cuda.synchronize()
        fused_em.reset_launches()
        t0 = time.perf_counter()
        with spied(odometry, "refine_odometry", calls):
            outs[name] = run_cli(argv)
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
        counts[name] = dict(fused_em.LAUNCHES)
        require_launched(counts[name], name)
    dead = parse_ate(outs["cli_odometry_sharded"])
    refined = parse_ate(outs["cli_odometry_closures_sharded"])
    text = outs["cli_odometry_closures_sharded"]
    if "loop closures accepted:" not in text:
        raise CheckFailed("cli odometry --sharded: no loop closure accepted")
    pairs = ast.literal_eval(text.split("loop closures accepted:")[1].splitlines()[0].strip())
    ate_bound = ODO_ATE_FACTOR * JAX_CLI_DEAD_ATE + ODO_ATE_SLACK
    if not any(j - i > 5 for i, j in pairs):
        raise CheckFailed(f"cli odometry --sharded: no accepted closure with j - i > 5: {pairs}")
    if not (dead == dead and refined == refined and dead <= ate_bound and refined < dead):
        raise CheckFailed(f"cli odometry --sharded: dead-reckoned ATE {dead} (bound {ate_bound}), "
                          f"refined {refined} (must be below it)")
    T = np.load(loc_p)
    loc_t = float(np.linalg.norm(T[:3, 3]))
    loc_deg = float(rotation_error_deg(Pose.from_matrix(torch.from_numpy(T.astype(np.float32))),
                                       Pose.identity()))
    if not (np.isfinite(T).all() and loc_t < LOC_TRANS and loc_deg < LOC_DEG):
        raise CheckFailed(f"cli localize --sharded: |t| = {loc_t} m, rotation {loc_deg} deg")
    out = {"ate_dead_reckoned_m": dead, "ate_refined_m": refined, "ate_bound_m": ate_bound,
           "closures": pairs, "localize_t_m": loc_t, "localize_rot_deg": loc_deg,
           "cli_wall_s": walls, "launches": counts}

    out["refine_chain_sharded"] = chain_check(torch, dev, mesh, calls[-1][0][0])
    out["seconds"] = time.perf_counter() - t_start
    return out, counts


def chain_check(torch, dev, mesh, result) -> dict:
    """(e) refine_chain_sharded on an odometry run's chain and closures, at
    world size 1 (mesh) and on SHARD_RANKS emulated ranks, against the dense
    refine_pose_graph within PG_ATOL."""
    from hgmm_torch.parallel import EmulatedMesh
    from hgmm_torch.pipelines.pose_graph import (concat_edge_lists, odometry_chain_edges,
                                                 refine_chain_sharded, refine_pose_graph)

    closures = result.closures
    R = torch.stack([p.R for p in result.abs_poses])
    t = torch.stack([p.t for p in result.abs_poses])
    chain = odometry_chain_edges(result.rel_poses)
    dense = refine_pose_graph(R, t, concat_edge_lists(chain, closures), n_iters=PG_ITERS)
    gaps = {}
    for name, m in (("nccl_ws1", mesh), (f"emulated_{SHARD_RANKS}", EmulatedMesh(SHARD_RANKS, dev))):
        t0 = time.perf_counter()
        got = refine_chain_sharded(R, t, chain.R, chain.t, m, n_iters=PG_ITERS, closures=closures)
        torch.cuda.synchronize()
        gaps[name] = {"t": close(torch, f"refine_chain_sharded {name} t", got.t, dense.t, 0.0, PG_ATOL),
                      "R": close(torch, f"refine_chain_sharded {name} R", got.R, dense.R, 0.0, PG_ATOL),
                      "seconds": time.perf_counter() - t0}
    return {"nodes": int(R.shape[0]), "closures": int(closures.i.numel()), "iters": PG_ITERS,
            "atol": PG_ATOL, "max_abs_gap_to_dense": gaps}


# --------------------------------------------------------------------------
# the native reader and the suites


@contextlib.contextmanager
def numpy_io():
    """Within the block the port's loaders take their numpy paths (the
    native library hidden from them)."""
    from hgmm_torch.data import native

    available = native.available
    native.available = lambda: False
    try:
        yield
    finally:
        native.available = available


def same_array(name, got, ref) -> None:
    if got is None or got.dtype != ref.dtype or got.shape != ref.shape or not (got == ref).all():
        raise CheckFailed(f"native {name}: not bit-equal to the numpy path "
                          f"({None if got is None else (got.dtype, got.shape)} vs {(ref.dtype, ref.shape)})")


def native_phase(torch, work, seq) -> dict:
    """The native reader (hgmm_torch/data/native.py): built with g++ unless
    it was (build_s), then its KITTI reads and voxel_downsample (NATIVE_VOXEL) on every scan of
    the odometry sequence, and its PLY read and voxel_downsample on the
    config-5 cloud (SHARD_N points of large_n.scene written as a binary PLY),
    each bit-equal to the numpy path; both paths timed (host clock)."""
    from hgmm_torch.benchmarks.large_n import scene
    from hgmm_torch.data import kitti, native, ply

    t0 = time.perf_counter()
    lib = native.build(verbose=False)
    build_s = time.perf_counter() - t0
    if not native.available():
        raise CheckFailed(f"native: {lib} built but not available")

    def both(name, native_fn, numpy_fn):
        t0 = time.perf_counter()
        got = native_fn()
        t1 = time.perf_counter()
        with numpy_io():
            ref = numpy_fn()
        t2 = time.perf_counter()
        same_array(name, got, ref)
        return got, t1 - t0, t2 - t1

    times = {key: [0.0, 0.0] for key in ("kitti_read", "kitti_voxel")}
    n_in = n_out = 0
    for path in kitti.sequence_scan_paths(seq):
        pts, a, b = both("load_kitti_bin", lambda: native.load_kitti_bin(str(path)),
                         lambda: kitti.load_velodyne_bin(path))
        times["kitti_read"] = [times["kitti_read"][0] + a, times["kitti_read"][1] + b]
        vox, a, b = both("voxel_downsample (scan)", lambda: native.voxel_downsample(pts, NATIVE_VOXEL),
                         lambda: kitti.voxel_downsample(pts, NATIVE_VOXEL))
        times["kitti_voxel"] = [times["kitti_voxel"][0] + a, times["kitti_voxel"][1] + b]
        n_in, n_out = n_in + pts.shape[0], n_out + vox.shape[0]

    cloud = scene(SHARD_N)
    ply_path = work / "config5.ply"
    try:
        t0 = time.perf_counter()
        ply.save_ply(ply_path, cloud)
        write_s = time.perf_counter() - t0
        ply_bytes = ply_path.stat().st_size
        pts, a, b = both("load_ply", lambda: native.load_ply(str(ply_path)), lambda: ply.load_ply(ply_path))
    finally:
        ply_path.unlink(missing_ok=True)
    same_array("load_ply (against the written cloud)", pts, cloud)
    times["ply_read"] = [a, b]
    vox, a, b = both("voxel_downsample (config 5)", lambda: native.voxel_downsample(pts, NATIVE_VOXEL),
                     lambda: kitti.voxel_downsample(pts, NATIVE_VOXEL))
    times["ply_voxel"] = [a, b]
    return {"library": lib.name, "build_s": build_s, "scans": len(kitti.sequence_scan_paths(seq)),
            "scan_points": n_in, "scan_points_after_voxel": n_out, "voxel_m": NATIVE_VOXEL,
            "ply_points": int(cloud.shape[0]), "ply_bytes": ply_bytes, "ply_write_s": write_s,
            "ply_points_after_voxel": int(vox.shape[0]), "bit_equal": True,
            "seconds_native_numpy": times}


def timed_shape(torch, kern, plain, **fields) -> dict:
    """A kernel-table entry of a shape newly on a path: the kernel's device
    ms by the profiler, CUDA events around its calls, the plain version's."""
    return {**fields, "ms": device_ms(torch, kern), "call_ms": cuda_ms(torch, kern),
            "plain_ms": cuda_ms(torch, plain, reps=5), "headline": False}


def registration_suite_phase(torch, dev, errs, timings) -> tuple:
    """registration_suite at N_POINTS on the card: every GMM record within
    the pose bounds (BOUNDS), ICP's RMSE below the starting pose's and its
    rotation within BOUNDS, every kernel of the path launched (the suite's
    ICP runs the reference's 30 iterations; on this dense cloud point-to-
    point ICP moves ~1 % of the way a step until it snaps to the exact
    matches, ~190 iterations at 437,645 points, so on an H100 it ends at RMSE
    0.042 from 0.055, outside the pose bounds; the reference's TPU run ends
    at 0.0207 on 100,000 points, RESULTS.md section 2; cli_icp holds ICP to
    ICP_RMSE at 250 iterations); then the shapes the suite puts on a path, each checked against
    its plain version and timed: the unmasked em_stats at K = 64 (the flat
    fit), reg_stats at K = 64 (the flat model, no outlier) and at the tree's
    leaves and adaptive cut with outlier 0.0, at the suite's final poses."""
    from hgmm_torch.benchmarks import registration_suite as suite
    from hgmm_torch.eval.metrics import registration_rmse
    from hgmm_torch.models.gmm import Gmm
    from hgmm_torch.models.gmm_tree import GmmTree, node_complexity
    from hgmm_torch.models.se3 import Pose
    from hgmm_torch.ops import em_ref, fused_em, prepare
    from hgmm_torch.ops.gaussians import pack_loglik_weights
    from hgmm_torch.pipelines.register import model_terms

    source, cloud, gt = suite.make_problem(N_POINTS, dev)
    torch.cuda.synchronize()
    fused_em.reset_launches()
    t0 = time.perf_counter()
    records, poses = suite.run(source, cloud, gt, emit=lambda r: log({"registration_suite": r}))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(fused_em.LAUNCHES)
    start_rmse = float(registration_rmse(Pose.identity(device=dev), source, gt))
    for r in records:
        bound = start_rmse if r["algorithm"] == "icp" else BOUNDS["rmse"]
        if not (r["rmse"] < bound and r["rot_err_deg"] < BOUNDS["rot_deg"]):
            raise CheckFailed(f"registration_suite {r['algorithm']}: rmse {r['rmse']} (bound {bound}), "
                              f"rotation {r['rot_err_deg']} deg (bound {BOUNDS['rot_deg']})")
    require_launched(counts, "registration_suite")

    n = N_POINTS
    gmm, _ = Gmm.fit(cloud, k=suite.FLAT_K, n_iters=suite.FLAT_SWEEPS,
                     generator=torch.Generator().manual_seed(3))
    tree, _ = GmmTree.fit(cloud, **suite.TREE, generator=torch.Generator().manual_seed(4))
    tgt, src = prepare(cloud), prepare(source)
    W = pack_loglik_weights(gmm.params)
    check_em(torch, "em_stats", fused_em.em_stats(tgt.pts4, W), em_ref.em_stats(cloud, W), n, errs)
    timings["em_stats"].append(timed_shape(
        torch, lambda: fused_em.em_stats(tgt.pts4, W), lambda: em_ref.em_stats(cloud, W),
        k=suite.FLAT_K, n=n, masked=False, path="registration_suite",
        body_ms=device_ms(torch, lambda: fused_em.em_partials(tgt.pts4, W))))
    thr = float(torch.quantile(node_complexity(tree.levels[-2]), 0.5))
    for name, params, outlier in (("gmm_flat64", gmm.params, None),
                                  ("hgmm_tree_8x3", tree.cut_mixture(0.0), 0.0),
                                  ("hgmm_adaptive_cut", tree.cut_mixture(thr), 0.0)):
        Wr, mu, A6, b3 = model_terms(params)
        pose = (poses[name].R, poses[name].t)
        ref = lambda: em_ref.reg_stats(source, Wr, mu, A6, b3, pose, outlier_logit=outlier)  # noqa: E731
        check_reg(torch, fused_em.reg_stats(src.pts4, Wr, mu, A6, b3, pose, outlier_logit=outlier),
                  ref(), n, errs)
        tab = fused_em.reg_tables(src.pts4, Wr, mu, A6, b3, outlier_logit=outlier)
        pose12 = torch.cat([pose[0].reshape(9), pose[1]]).contiguous()
        timings["reg_stats"].append(timed_shape(
            torch, lambda: fused_em.reg_partials(tab, pose12), ref, k=int(Wr.shape[1]), n=n,
            outlier_logit=outlier, path=f"registration_suite {name}", lanes=tab.plan.lanes,
            blocks=tab.plan.blocks))
    return counts, {"n": n, "wall_s": wall, "start_rmse": start_rmse, "records": records}


def odometry_suite_phase(torch, dev, work) -> tuple:
    """odometry_suite at its defaults (ODO_SUITE, with e2e), each phase under
    a device-only trace (its device_busy_s), then ODO_SUITE_SHARDED over the
    smoke's NCCL mesh: the default run must accept a closure, refine below
    dead reckoning (refine and e2e), localize within LOC_SUITE_TARGET of the
    refined pose or nearer it than its dead-reckoned start, and launch each
    phase's kernels; the sharded run must localize likewise and launch
    the path's kernels."""
    from hgmm_torch.benchmarks import odometry_suite as suite
    from hgmm_torch.ops import fused_em

    counts, out = {}, {}
    for path, kw in (("odometry_suite", dict(ODO_SUITE, trace_dir=work / "odo_suite_trace")),
                     ("odometry_suite_sharded", dict(ODO_SUITE_SHARDED, sharded=True))):
        torch.cuda.synchronize()
        fused_em.reset_launches()
        t0 = time.perf_counter()
        try:
            records = suite.run(device=dev, emit=lambda r, p=path: log({p: r}), **kw)
        finally:
            shutil.rmtree(work / "odo_suite_trace", ignore_errors=True)
        counts[path] = dict(fused_em.LAUNCHES)
        out[path] = {"seconds": time.perf_counter() - t0, "records": records}
        require_launched(counts[path], path)
        rec = {r["phase"]: r for r in records}
        err, start = rec["localize"]["err_vs_refined_t"], rec["localize"]["init_vs_refined_t"]
        out[path]["localize_within_target"] = err < LOC_SUITE_TARGET
        if not err < max(start, LOC_SUITE_TARGET):
            raise CheckFailed(f"{path}: localize {err} m from the refined pose: neither within "
                              f"{LOC_SUITE_TARGET} m nor nearer than its dead-reckoned start ({start} m)")
        if path != "odometry_suite":
            continue
        if rec["closures"]["accepted"] < 1:
            raise CheckFailed(f"{path}: no loop closure accepted")
        for phase in ("refine", "e2e"):
            if not rec[phase]["ate_refined"] < rec[phase]["ate_dead"]:
                raise CheckFailed(f"{path} {phase}: refined ATE {rec[phase]['ate_refined']} not below "
                                  f"dead-reckoned {rec[phase]['ate_dead']}")
        for phase, names in ODO_PHASE_KERNELS.items():
            missing = [k for k in names if not rec[phase]["launches"].get(k)]
            if missing:
                raise CheckFailed(f"{path} {phase}: kernels never launched: {missing}")
    return counts, out


def scaling_phase(torch, dev) -> tuple:
    """scaling at SCALING on the card at the smoke's world size (one NCCL
    rank): the sharding overhead printed, and the one-rank sharded fit's
    parameters bit-equal to the unsharded fit's."""
    from hgmm_torch.benchmarks import scaling
    from hgmm_torch.ops import fused_em

    torch.cuda.synchronize()
    fused_em.reset_launches()
    t0 = time.perf_counter()
    records, params = scaling.run(**SCALING, device=dev, emit=lambda r: log({"scaling": r}))
    counts = dict(fused_em.LAUNCHES)
    require_launched(counts, "scaling")
    one = next(r for r in records if r["devices"] == 1)
    if not (one["sharding_overhead"] == one["sharding_overhead"] and one["points_per_sec"] > 0):
        raise CheckFailed(f"scaling: {one}")
    unequal = [key for key in ("pi", "mu", "sigma")
               if not torch.equal(getattr(params[1], key), getattr(params["unsharded"], key))]
    if unequal:
        raise CheckFailed(f"scaling: the one-rank sharded fit's {unequal} differ from the unsharded fit's")
    return counts, {"seconds": time.perf_counter() - t0, "records": records, "bit_equal": True}


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception as exc:  # any failed phase: report it and exit non-zero
        import traceback

        traceback.print_exc()
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
