"""hgmm_torch.ops.probes (the plain versions of the unit-rate probes) against
the Pallas bodies of benchmarks/mxu_microbench.py and vpu_microbench.py.

The same seeded numpy inputs go through the JAX body, run in interpret mode on
the CPU (pallas_call is wrapped with interpret=True from here; nothing in
benchmarks/ changes), and through the port's plain version. bfloat16 operands
carry identical bits in both (convert.probe_inputs_from_numpy rounds as
jnp.astype(bfloat16)), products of bfloat16 values are exact in float32, so
only the order of the float32 sums differs: rtol 1e-3 on the matrix sums
(plus 1e-5 of the largest |sum| for sums that land near zero). The exp2 chain
is compared bit for bit after its final bfloat16 rounding, allowing one
bfloat16 ulp where the two exp2 implementations differ in the last place.

The CUDA kernels themselves (csrc/probes.cu) are held against these plain
versions on the card: tests/test_torch_kernels.py and chip_smoke.py.
"""

import functools
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from hgmm_torch import convert
from hgmm_torch.ops import fused_em, probes

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "benchmarks"))
import mxu_microbench as jmxu  # noqa: E402
import vpu_microbench as jvpu  # noqa: E402

torch.set_num_threads(2)

K, T, STEPS, REPS = 64, 256, 3, 2


@pytest.fixture
def interpret(monkeypatch):
    """Run every pallas_call of the benchmark modules in interpret mode."""
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    return {"wt": rng.standard_normal((K, 80)).astype(np.float32),
            "phi": rng.standard_normal((80, T)).astype(np.float32),
            "e": rng.uniform(size=(K, T)).astype(np.float32),
            "x": rng.standard_normal((K, T)).astype(np.float32),
            "ones": np.ones((8, K), np.float32),
            # norm's A operand varying along K (with all ones, a kernel that
            # mixed up the K-major layout of its B tiles would pass)
            "ones_rand": rng.standard_normal((8, K)).astype(np.float32)}


def _bf16(a):
    return jnp.asarray(a).astype(jnp.bfloat16)


CASES = {
    "logits": (jmxu._logits_kernel, ("wt", "phi"), (K, T), probes.logits),
    "stats": (jmxu._stats_kernel, ("phi32", "e"), (32, K), probes.stats),
    "norm": (jmxu._norm_kernel, ("ones", "e"), (8, T), probes.norm),
    "norm_random": (jmxu._norm_kernel, ("ones_rand", "e"), (8, T), probes.norm),
}


@pytest.mark.parametrize("name", list(CASES))
def test_matrix_body_matches_pallas(interpret, name):
    kern, operands, out_shape, port = CASES[name]
    ins = _inputs()
    ins["phi32"] = ins["phi"][:32]
    arrs = [ins[o] for o in operands]
    f = jmxu.build(kern, [a.shape for a in arrs], None, out_shape, STEPS, REPS)
    ref = np.asarray(f(*map(_bf16, arrs)))
    got = port(*convert.probe_inputs_from_numpy(*arrs), STEPS, REPS)
    assert got.dtype == torch.float32 and tuple(got.shape) == out_shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-3, atol=1e-5 * np.abs(ref).max())
    # and it is steps * reps products, not one
    one = port(*convert.probe_inputs_from_numpy(*arrs), 1, 1).numpy()
    np.testing.assert_allclose(got.numpy(), STEPS * REPS * one, rtol=2e-2,
                               atol=1e-3 * np.abs(ref).max())


ZERO_A = {"logits": (jmxu._logits_kernel, ("wt", "phi"), (K, T), probes.logits),
          "stats": (jmxu._stats_kernel, ("phi32", "e"), (32, K), probes.stats),
          "norm": (jmxu._norm_kernel, ("ones", "e"), (8, T), probes.norm)}


@pytest.mark.parametrize("steps,reps", [(1, 1), (3, 6), (2, 64)])
@pytest.mark.parametrize("name", list(ZERO_A))
def test_zero_a_sees_every_rep_eps(interpret, name, steps, reps):
    """A = 0 (wt for logits, phi32 for stats, ones for norm): the result is
    steps * sum_r eps_r times B's column sums, so each rep's eps counts. With normal
    operands bf16(x + 1e-6) = x for all but ~1 element in 5,000, and a kernel
    that dropped or hoisted eps_r would pass; here it cannot."""
    kern, operands, out_shape, port = ZERO_A[name]
    ins = _inputs(2)
    ins["phi32"] = np.zeros((32, T), np.float32)
    ins["wt"] = np.zeros((K, 80), np.float32)
    ins["ones"] = np.zeros((8, K), np.float32)
    arrs = [ins[o] for o in operands]
    f = jmxu.build(kern, [a.shape for a in arrs], None, out_shape, steps, reps)
    ref = np.asarray(f(*map(_bf16, arrs)))
    got = port(*convert.probe_inputs_from_numpy(*arrs), steps, reps).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-5 * np.abs(ref).max())
    eps = probes.eps_table(reps, torch.bfloat16).to(torch.float64).numpy()
    b = np.asarray(_bf16(arrs[1]).astype(jnp.float32), np.float64)
    colsum = b.sum(1) if name == "stats" else b.sum(0)  # B = phi [80, T], e [K, T], or e transposed
    want = steps * eps.sum() * colsum
    np.testing.assert_allclose(got, np.broadcast_to(want, out_shape), rtol=1e-3,
                               atol=1e-5 * np.abs(want).max())
    if reps > 1:  # one rep's eps taken for all of them is far off
        wrong = steps * reps * eps[0] * colsum
        assert np.abs(got - wrong).max() > 0.1 * np.abs(wrong).max()


def test_addonly_body_matches_pallas(interpret):
    x = _inputs()["x"]
    f = jmxu.build(jmxu._addonly_kernel, [(K, T)], None, (K, T), STEPS, REPS)
    ref = np.asarray(f(jnp.asarray(x)))
    got = probes.addonly(torch.from_numpy(x), STEPS, REPS).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got, (1 + STEPS * REPS) * x, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("mode", ["exp2", "cast"])
def test_vpu_body_matches_pallas(interpret, mode):
    x = (-1.5 + np.random.default_rng(0).uniform(size=(32, 128))).astype(np.float32)
    ref = np.asarray(jvpu.build(32, 128, STEPS, REPS, mode)(jnp.asarray(x)))
    got = probes.vpu(torch.from_numpy(x), STEPS, REPS, mode)
    bits = lambda a: torch.from_numpy(np.array(a)).to(torch.bfloat16).view(torch.int16).int()  # noqa: E731
    assert torch.equal(got.to(torch.bfloat16).to(torch.float32), got)  # bfloat16 values
    ulp = (bits(got.numpy()) - bits(ref)).abs()
    assert int(ulp.max()) <= (1 if mode == "exp2" else 0)
    assert float((ulp > 0).float().mean()) < 0.01


def test_vpu_chain_converges_to_the_fixed_point():
    """The chain has no over- or underflow: it converges to the fixed point
    x* = -exp2(x*) = -0.64119 (benchmarks/vpu_microbench.py:17-18 says why the
    chain is safe; the value it quotes, -0.7666, is not the root)."""
    x = torch.full((4, 4), -1.2)
    out = probes.vpu(x, 8, 4, "exp2")
    assert float((out + 0.64119).abs().max()) < 4e-3  # one bfloat16 ulp at 0.64
    with pytest.raises(ValueError, match="mode"):
        probes.vpu(x, 1, 1, "log2")


def test_eps_table_has_jax_bits():
    reps = probes.MAX_REPS
    ref = np.array([np.asarray(jnp.bfloat16(1e-6 * (r + 1)).astype(jnp.float32)) for r in range(reps)])
    got = probes.eps_table(reps, torch.bfloat16).to(torch.float32).numpy()
    np.testing.assert_array_equal(got, ref)
    ref32 = np.array([np.float32(jnp.float32(1e-6 * (r + 1))) for r in range(reps)])
    np.testing.assert_array_equal(probes.eps_table(reps, torch.float32).numpy(), ref32)


def test_probe_inputs_round_as_jax():
    a = np.random.default_rng(3).standard_normal((33, 17)).astype(np.float32) * 1e3
    a[0, :4] = [1.00390625, 1.01171875, -1.00390625, 3.0e-39]  # exact ties, a subnormal
    (got,) = convert.probe_inputs_from_numpy(a)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.to(torch.float32).numpy(),
                                  np.asarray(_bf16(a).astype(jnp.float32)))


@pytest.mark.parametrize("name", ["logits", "stats"])
def test_float32_mode_against_float64(name):
    """The float32 arithmetic (FMA mode) of logits and stats: the same sums on
    float32 operands, held to a float64 evaluation."""
    ins = _inputs(1)
    a, b = (ins["wt"], ins["phi"]) if name == "logits" else (ins["phi"][:32], ins["e"])
    got = getattr(probes, name)(torch.from_numpy(a), torch.from_numpy(b), STEPS, REPS).numpy()
    bb = b if name == "logits" else b.T
    ref = STEPS * sum((a.astype(np.float64) + np.float64(np.float32(1e-6 * (r + 1)))) @ bb
                      for r in range(REPS))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("k,t", [(512, 2048), (64, 8192), (64, 256), (512, 512)])
def test_plans_fill_the_card_and_divide_the_shapes(k, t):
    """The launch geometry the wrappers pass to csrc/probes.cu: whole tiles,
    and at the benchmark's shapes blocks for (nearly) every SM. The bf16
    logits and stats bodies (wgmma) take a tile width that is a multiple of 8
    and divides T, and at the two MXU shapes their blocks fill whole waves of
    the SMs to within an eighth of the SMs (probes.FILL): one block a
    warpgroup, or two warpgroups sharing a stats block's B tiles."""
    sms = 132  # an H100's
    plans = {"logits_bf16": probes.plan_logits(k, t, False, sms),
             "logits_f32": probes.plan_logits(k, t, True, sms),
             "stats_bf16": probes.plan_stats(k, t, False, sms),
             "stats_f32": probes.plan_stats(k, t, True, sms), "norm": probes.plan_norm(k, t, sms)}
    # The wgmma bodies fill FILL of the SMs: on an H100 norm's 128 blocks of
    # (64, 2) at K = 512 beat 256 blocks of (64, 1) or (32, 2) (PERF.md section 6).
    wgmma = ("logits_bf16", "stats_bf16", "norm")
    for name, p in plans.items():
        assert p.blocks >= 1 and p.threads in (32, 64, 96, 128, 256), (name, p)
        if (k, t) in ((512, 2048), (64, 8192)):
            assert p.blocks >= (probes.FILL * sms if name in wgmma else sms), (name, p)
    lb, sb, nb = plans["logits_bf16"], plans["stats_bf16"], plans["norm"]
    assert lb.tile in probes.LOGITS_N and lb.threads == 128
    assert (sb.tile, sb.threads // 128) in probes.STATS_TILES and sb.threads % 128 == 0
    for p in (lb, sb):
        assert p.tile % 8 == 0 and t % p.tile == 0, p
        assert p.grid == (t // p.tile, k // (64 * (p.threads // 128))), p
    for p in (lb, sb, nb):
        if (k, t) in ((512, 2048), (64, 8192)):
            waves = -(-p.blocks // sms)
            assert waves * sms - p.blocks <= sms // 8, p  # the last wave is (nearly) full
    assert lb.partials == 0 and sb.partials == t // sb.tile
    assert plans["logits_f32"].grid == (t // 128, k // 16)
    sf = plans["stats_f32"]
    assert sf.tile == 32 and sf.partials == t // 32 and sf.grid[1] * sf.threads == k
    # norm (wgmma, its transpose): G warpgroups a block, one 64-row tile of T
    # each, over a K slice of D = tile; the K slices are partials.
    g = nb.threads // 128
    assert (nb.tile, g) in probes.NORM_TILES and k % nb.tile == 0 and nb.threads % 128 == 0
    assert nb.grid == (-(-t // (64 * g)), k // nb.tile) and nb.partials == k // nb.tile


# Every shape that tests/test_torch_kernels.py runs the probes at.
CARD_TEST_SHAPES = [(64, 256), (128, 384), (512, 2048), (64, 8192)]
CARD_NORM_SHAPES = [(64, 256), (128, 48), (256, 2048), (512, 2048), (64, 8192)]


@pytest.mark.parametrize("k,t", CARD_TEST_SHAPES)
@pytest.mark.parametrize("sms", [132, 114, 1])
def test_bf16_plans_keep_the_card_tests_shapes(k, t, sms):
    """The wgmma bodies take only their compiled tiles (N in LOGITS_N; (D, G)
    in STATS_TILES); every shape the card tests run gets one, on any SM
    count, and among the tiles that fill the card no other gives the busiest
    SM less work (stats: weighted by 1 + 1 / G, its fenced B stores)."""
    def least(cands, weight):
        cost, full = {}, []
        for w, g in cands:
            if t % w or k % (64 * g):
                continue
            blocks = (t // w) * (k // (64 * g))
            cost[(w, g)] = -(-blocks // sms) * w * g * weight(g)
            if blocks >= 7 / 8 * sms:
                full.append((w, g))
        return cost, min(cost[c] for c in (full or cost))

    lp = probes.plan_logits(k, t, False, sms)
    assert lp.tile in probes.LOGITS_N and lp.threads == 128 and lp.grid == (t // lp.tile, k // 64)
    cost, low = least([(n, 1) for n in probes.LOGITS_N], lambda g: 1.0)
    assert cost[(lp.tile, 1)] == low
    sp = probes.plan_stats(k, t, False, sms)
    g = sp.threads // 128
    assert (sp.tile, g) in probes.STATS_TILES and k % (64 * g) == 0
    assert sp.grid == (t // sp.tile, k // (64 * g)) and sp.partials == t // sp.tile
    cost, low = least(probes.STATS_TILES, lambda gg: 1 + 1 / gg)
    assert cost[(sp.tile, g)] == low


def test_stats_plan_shares_b_where_k_allows():
    """At K = 512, T = 2048 two warpgroups share each B tile (its fenced
    stores halve); at K = 64 there is one 64-row slice of K."""
    assert probes.plan_stats(512, 2048, False, 132).threads == 256
    assert probes.plan_stats(64, 8192, False, 132).threads == 128


@pytest.mark.parametrize("k,t", CARD_NORM_SHAPES)
def test_norm_plan_keeps_the_card_tests_shapes(k, t):
    """The norm body takes only its compiled tiles ((D, G) in NORM_TILES, D
    dividing 128 G); its grid covers every row of T once, the last 64-row
    tile possibly partial (T = 48), on any SM count; and among the tiles
    that fill the card none gives the busiest SM less work, weighted as
    stats' by 1 + 1 / G for the B stores its warpgroups share."""
    for sms in (132, 114, 1):
        p = probes.plan_norm(k, t, sms)
        g = p.threads // 128
        assert (p.tile, g) in probes.NORM_TILES and 128 * g % p.tile == 0 and t % 16 == 0
        assert k % p.tile == 0 and p.grid[1] == k // p.tile == p.partials
        assert (p.grid[0] - 1) * 64 * g < t <= p.grid[0] * 64 * g
        blocks = {(d, gg): -(-t // (64 * gg)) * (k // d) for d, gg in probes.NORM_TILES}
        cost = {c: -(-b // sms) * c[0] * c[1] * (1 + 1 / c[1]) for c, b in blocks.items()}
        full = [c for c, b in blocks.items() if b >= 7 / 8 * sms] or list(blocks)
        assert cost[(p.tile, g)] == min(cost[c] for c in full)


def test_plans_refuse_ragged_shapes():
    for call in (lambda: probes.plan_logits(48, 256, False, 132),
                 lambda: probes.plan_logits(64, 200, True, 132),
                 lambda: probes.plan_stats(64, 100, False, 132), lambda: probes.plan_norm(32, 256, 132)):
        with pytest.raises(ValueError):
            call()


@pytest.mark.parametrize("name", ["logits", "stats", "norm", "addonly", "vpu"])
def test_probe_wrappers_refuse_cpu_tensors(name):
    """A kernel wrapper launches on CUDA tensors or raises; it never falls
    back, and the dispatch sends CPU tensors to the plain version uncounted."""
    ins = {k: torch.from_numpy(v) for k, v in _inputs().items()}
    wt, phi, e, ones = convert.probe_inputs_from_numpy(*(ins[n].numpy() for n in ("wt", "phi", "e", "ones")))
    args = {"logits": (wt, phi), "stats": (phi[:32], e), "norm": (ones, e), "addonly": (ins["x"],),
            "vpu": (ins["x"],)}[name]
    with pytest.raises(ValueError, match="CUDA"):
        getattr(probes, name + "_cuda")(*args, 1, 1)
    fused_em.reset_launches()
    out = getattr(probes, name)(*args, 1, 1)
    assert bool(torch.isfinite(out).all())
    assert fused_em.LAUNCHES["probe_" + name] == 0
