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
            "ones": np.ones((8, K), np.float32)}


def _bf16(a):
    return jnp.asarray(a).astype(jnp.bfloat16)


CASES = {
    "logits": (jmxu._logits_kernel, ("wt", "phi"), (K, T), probes.logits),
    "stats": (jmxu._stats_kernel, ("phi32", "e"), (32, K), probes.stats),
    "norm": (jmxu._norm_kernel, ("ones", "e"), (8, T), probes.norm),
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
    and at the benchmark's shapes at least one block for every SM."""
    sms = 132  # an H100's
    plans = {"logits_bf16": probes.plan_logits(k, t, False, sms),
             "logits_f32": probes.plan_logits(k, t, True, sms),
             "stats_bf16": probes.plan_stats(k, t, False, sms),
             "stats_f32": probes.plan_stats(k, t, True, sms), "norm": probes.plan_norm(k, t, sms)}
    for name, p in plans.items():
        assert p.blocks >= 1 and p.threads in (32, 64, 96, 128), (name, p)
        if (k, t) in ((512, 2048), (64, 8192)):
            assert p.blocks >= sms, (name, p)
    assert plans["logits_bf16"].tile in (32, 64) and t % plans["logits_bf16"].tile == 0
    assert plans["logits_bf16"].grid == (t // plans["logits_bf16"].tile, k // 64)
    assert plans["logits_f32"].grid == (t // 128, k // 16)
    sb, sf = plans["stats_bf16"], plans["stats_f32"]
    assert sb.partials == t // sb.tile == sb.grid[0] and sb.grid[1] == k // 64
    assert sf.tile == 32 and sf.partials == t // 32 and sf.grid[1] * sf.threads == k
    nk = plans["norm"].tile
    assert nk in (1, 2, 4) and plans["norm"].grid == (t // 16, k // (64 * nk))
    assert plans["norm"].partials == k // (64 * nk)


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
