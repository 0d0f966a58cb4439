"""Port base conversion (troy_tpu_torch/ops/bconv.py, the plain version of
the Hopper kernel K3) against the JAX package's BaseConverter.convert under
both of its backends: the Pallas kernel bconv_pallas (K3, interpret mode
here) and the VPU dot.  Bit for bit, at generic shapes and at every
conversion of the BFV multiply and decrypt, including the output base
Bsk u {m~} whose last modulus m~ = 2^16 is not prime."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from troy_tpu.core.modulus import Modulus as JModulus
from troy_tpu.rns import rns_base as JRB
from troy_tpu.rns.rns_tool import RNSTool as JTool
from troy_tpu.utils import numth
from troy_tpu_torch.core.modulus import Modulus
from troy_tpu_torch.ops import bconv as BC, bconv_cuda
from troy_tpu_torch.rns.rns_base import RNSBase, BaseConverter
from troy_tpu_torch.rns.rns_tool import RNSTool

RNG = np.random.default_rng(303)
N = 256


def residues(lead, values, n=N):
    q = np.array(values, dtype=np.uint64)[:, None]
    return (RNG.integers(0, 1 << 62, size=(*lead, len(values), n), dtype=np.uint64)
            % q).astype(np.uint32)


def jax_convert(conv, x, backend):
    prev = JRB.get_bconv_backend()
    try:
        JRB.set_bconv_backend(backend)
        return np.asarray(conv.convert(jnp.asarray(x)))
    finally:
        JRB.set_bconv_backend(prev)


def check(jconv, tconv, x):
    got = BC.base_convert(torch.from_numpy(x.astype(np.int64)), tconv.tables).numpy()
    assert got.shape == (*x.shape[:-2], tconv.obase.size, x.shape[-1])
    for backend in ("pallas", "vpu"):
        np.testing.assert_array_equal(jax_convert(jconv, x, backend).astype(np.int64),
                                      got, err_msg=backend)


@pytest.mark.parametrize("L_in,L_out", [(3, 4), (15, 9), (1, 3)])
def test_generic_bases(L_in, L_out):
    """As tests/rns/test_rns.py runs K3: 30-bit input primes, 29-bit output
    primes, a batched leading axis; and a single input limb."""
    iv = numth.get_primes(2 * N, 30, L_in)
    ov = numth.get_primes(2 * N, 29, L_out)
    jconv = JRB.BaseConverter(JRB.RNSBase([JModulus(p) for p in iv]),
                              JRB.RNSBase([JModulus(p) for p in ov]))
    tconv = BaseConverter(RNSBase([Modulus(p) for p in iv], "cpu"),
                          RNSBase([Modulus(p) for p in ov], "cpu"))
    check(jconv, tconv, residues((2,), iv))


@pytest.fixture(scope="module")
def tools():
    log_n, L = 8, 3
    n = 1 << log_n
    primes = numth.get_primes(2 * n, 30, L)
    t = numth.get_prime(2 * n, 20)
    jt = JTool(log_n, JRB.RNSBase([JModulus(p) for p in primes]), JModulus(t))
    tt = RNSTool(log_n, RNSBase([Modulus(p) for p in primes], "cpu"), Modulus(t))
    return jt, tt


@pytest.mark.parametrize("conv,ibase", [
    ("conv_q_to_Bsk_m_tilde", "base_q"),
    ("conv_q_to_Bsk", "base_q"),
    ("conv_B_to_q", "base_B"),
    ("conv_B_to_m_sk", "base_B"),
    ("conv_q_to_t_gamma", "base_q"),
])
def test_path_conversions(tools, conv, ibase):
    jt, tt = tools
    x = residues((2, 3), getattr(tt, ibase).values)
    check(getattr(jt, conv), getattr(tt, conv), x)


def test_m_tilde_row_is_reduced(tools):
    """The m~ row of q -> Bsk u {m~} comes out in [0, 2^16)."""
    _, tt = tools
    x = torch.from_numpy(residues((4,), tt.base_q.values).astype(np.int64))
    y = tt.conv_q_to_Bsk_m_tilde.convert(x)
    assert int(y[..., -1, :].max()) < (1 << 16)
    assert int(y[..., -1, :].max()) >= (1 << 15)


def test_kernel_tables_layout(tools):
    """kernel_tables holds [q_in, ip, ip Shoup, p_out, M row-major] as u32."""
    _, tt = tools
    tabs = tt.conv_q_to_Bsk_m_tilde.tables
    words = tabs.kernel_tables.numpy().view(np.uint32).astype(np.int64)
    L_in, L_out = tabs.L_in, tabs.L_out
    q, ip = tabs.q_in.numpy(), tabs.ip.numpy()
    np.testing.assert_array_equal(words[:L_in], q)
    np.testing.assert_array_equal(words[L_in:2 * L_in], ip)
    np.testing.assert_array_equal(words[2 * L_in:3 * L_in], (ip << 32) // q)
    np.testing.assert_array_equal(words[3 * L_in:3 * L_in + L_out], tabs.p_out.numpy())
    np.testing.assert_array_equal(words[3 * L_in + L_out:], tabs.mat.numpy().ravel())
    assert words.size == 3 * L_in + L_out + L_out * L_in


def test_kernel_wrapper_refuses_cpu_tensors(tools):
    """The CUDA wrapper launches or raises; it never computes on the CPU."""
    _, tt = tools
    x = torch.zeros(1, tt.base_q.size, 16, dtype=torch.int64)
    with pytest.raises(ValueError):
        bconv_cuda.base_convert(x, tt.conv_q_to_Bsk.tables)
    assert bconv_cuda.LAUNCHES == {"base_convert": 0}
