"""Port RNS layer (troy_tpu_torch/rns) against the JAX package, bit for bit:
base conversion, the HPS lift with its float32 alpha, the BEHZ m~ / sm_mrq
lift, the t-folded fast floor with the Shenoy-Kumaresan conversion (also
against the JAX package's unfused floor), BFV decrypt rounding, the
encrypt-side scale_up, and the host CRT compose."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from troy_tpu.core.modulus import Modulus as JModulus
from troy_tpu.ops import poly as JP
from troy_tpu.rns import rns_base as JRB
from troy_tpu.rns.rns_base import RNSBase as JBase
from troy_tpu.rns.rns_tool import RNSTool as JTool
from troy_tpu.rns.scaling import BFVScaler as JScaler
from troy_tpu.utils import numth
from troy_tpu_torch.core.modulus import Modulus
from troy_tpu_torch.rns.rns_base import RNSBase
from troy_tpu_torch.rns.rns_tool import RNSTool
from troy_tpu_torch.rns.scaling import BFVScaler

RNG = np.random.default_rng(77)


def tools(log_n, L, log_t=20):
    n = 1 << log_n
    primes = numth.get_primes(2 * n, 30, L)
    t = numth.get_prime(2 * n, log_t)
    jt = JTool(log_n, JBase([JModulus(p) for p in primes]), JModulus(t))
    tt = RNSTool(log_n, RNSBase([Modulus(p) for p in primes], "cpu"), Modulus(t))
    return jt, tt


def residues(lead, values, n):
    q = np.array(values, dtype=np.uint64)[:, None]
    return (RNG.integers(0, 1 << 62, size=(*lead, len(values), n), dtype=np.uint64)
            % q).astype(np.uint32)


def same(j, t):
    np.testing.assert_array_equal(np.asarray(j).astype(np.int64), t.numpy())


def tensor(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


@pytest.mark.parametrize("log_n,L", [(10, 3)])
def test_base_convert(log_n, L):
    jt, tt = tools(log_n, L)
    x = residues((2,), tt.base_q.values, 1 << log_n)
    same(jt.conv_q_to_Bsk.convert(jnp.asarray(x)), tt.conv_q_to_Bsk.convert(tensor(x)))
    y = residues((2,), tt.base_B.values, 1 << log_n)
    same(jt.conv_B_to_q.convert(jnp.asarray(y)), tt.conv_B_to_q.convert(tensor(y)))


@pytest.mark.parametrize("log_n,L", [(10, 3), (11, 6)])
def test_hps_lift(log_n, L):
    """Over 2*2*n coefficients the float32 alpha estimate rounds the same way
    in both packages; any difference would show as a residue off by Q mod b.
    The JAX lift runs jitted, as the JAX package's evaluator and batched
    steps run it (XLA fuses each product into the sum, which eager
    operations do not)."""
    jt, tt = tools(log_n, L)
    x = residues((2, 2), tt.base_q.values, 1 << log_n)
    same(jax.jit(jt.materialize().fast_b_conv_hps)(jnp.asarray(x)),
         tt.fast_b_conv_hps(tensor(x)))


def test_hps_lift_near_half():
    """Inputs whose fraction sum_i y_i/q_i sits near k + 1/2, where the
    rounding of alpha is decided by the last bits of the float32 sum (the
    JAX lift jitted, as in test_hps_lift)."""
    jt, tt = tools(10, 3)
    base = tt.base_q
    n = 1 << 10
    # x = round((k + 1/2 + eps) * Q) for small eps: the CRT fraction is near 1/2
    eps = RNG.integers(-(1 << 12), 1 << 12, size=n)
    vals = [(base.prod // 2 + int(e) * (base.prod >> 40)) % base.prod for e in eps]
    x = jt.base_q.decompose_array_host(vals)[None]
    same(jax.jit(jt.materialize().fast_b_conv_hps)(jnp.asarray(x)),
         tt.fast_b_conv_hps(tensor(x)))


@pytest.mark.parametrize("log_n,L", [(10, 3)])
def test_fast_floor_scale_fast_b_conv_sk(log_n, L):
    jt, tt = tools(log_n, L)
    n = 1 << log_n
    d_q = residues((2, 3), tt.base_q.values, n)
    d_b = residues((2, 3), tt.base_Bsk.values, n)
    same(jt.fast_floor_scale_fast_b_conv_sk(jnp.asarray(d_q), jnp.asarray(d_b)),
         tt.fast_floor_scale_fast_b_conv_sk(tensor(d_q), tensor(d_b)))


@pytest.mark.parametrize("log_n,L", [(10, 3), (9, 6)])
def test_behz_lift(log_n, L):
    """fast_b_conv_m_tilde_sm_mrq under both JAX base-conversion backends:
    the VPU dot and the Pallas kernel K3 (interpret mode), whose tables come
    from a non-prime modulus m~ = 2^16."""
    jt, tt = tools(log_n, L)
    x = residues((2, 2), tt.base_q.values, 1 << log_n)
    got = tt.fast_b_conv_m_tilde_sm_mrq(tensor(x))
    prev = JRB.get_bconv_backend()
    try:
        for backend in ("vpu", "pallas"):
            JRB.set_bconv_backend(backend)
            same(jt.fast_b_conv_m_tilde_sm_mrq(jnp.asarray(x)), got)
    finally:
        JRB.set_bconv_backend(prev)


@pytest.mark.parametrize("log_n,L", [(10, 3)])
def test_folded_floor_matches_unfused(log_n, L):
    """The port has only the t-folded floor; it equals the JAX package's
    unfused floor, a separate x t pass and conv_q_to_Bsk, as the JAX
    evaluator composes them off the VPU backend (evaluator.py:374-376)."""
    jt, tt = tools(log_n, L)
    n = 1 << log_n
    d_q = residues((2, 3), tt.base_q.values, n)
    d_b = residues((2, 3), tt.base_Bsk.values, n)
    t = tt.t.value
    w_q = JP.multiply_scalar(jnp.asarray(d_q), t, jt.base_q.pack())
    w_b = JP.multiply_scalar(jnp.asarray(d_b), t, jt.base_Bsk.pack())
    got = tt.fast_floor_scale_fast_b_conv_sk(tensor(d_q), tensor(d_b))
    prev = JRB.get_bconv_backend()
    try:
        for backend in ("vpu", "pallas"):
            JRB.set_bconv_backend(backend)
            same(jt.fast_floor_fast_b_conv_sk(w_q, w_b), got)
    finally:
        JRB.set_bconv_backend(prev)


def test_compose_array_host():
    jt, tt = tools(10, 3)
    for base, jbase in ((tt.base_q, jt.base_q), (tt.base_Bsk, jt.base_Bsk)):
        x = residues((), base.values, 64)
        got = base.compose_array_host(x)
        assert got == jbase.compose_array_host(x)
        assert all(isinstance(v, int) and 0 <= v < base.prod for v in got)


@pytest.mark.parametrize("log_n,L", [(10, 3)])
def test_decrypt_scale_and_round(log_n, L):
    jt, tt = tools(log_n, L)
    phase = residues((2,), tt.base_q.values, 1 << log_n)
    same(jt.decrypt_scale_and_round(jnp.asarray(phase)),
         tt.decrypt_scale_and_round(tensor(phase)))


@pytest.mark.parametrize("log_n,L", [(10, 3)])
def test_scale_up(log_n, L):
    jt, tt = tools(log_n, L)
    t = tt.t.value
    m = np.concatenate([[0, 1, t // 2, t // 2 + 1, t - 1],
                        RNG.integers(0, t, size=(1 << log_n) - 5)]).astype(np.uint32)
    js = JScaler(jt.base_q, jt.t)
    ts = BFVScaler(tt.base_q, tt.t)
    same(js.scale_up(jnp.asarray(m)), ts.scale_up(tensor(m)))
