"""Port NTT (troy_tpu_torch/ops/ntt.py) against every NTT of the JAX
package: radix-2, six-step, and both Pallas kernels (K1 ntt_forward_pallas,
K2 ntt_forward_pallas_mxu) in interpret mode.  Bit for bit, including lazy
inputs in [0, 2q)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import troy_tpu.ops.ntt as JNTT
from troy_tpu.ops.ntt_mxu import MxuNTTTables
from troy_tpu.ops.ntt_pallas import (ntt_forward_pallas, ntt_inverse_pallas,
                                     ntt_forward_pallas_mxu,
                                     ntt_inverse_pallas_mxu)
from troy_tpu.core.modulus import Modulus as JModulus
from troy_tpu.utils import numth
from troy_tpu_torch.core.modulus import Modulus
from troy_tpu_torch.ops import ntt as TNTT, ntt_cuda

RNG = np.random.default_rng(2024)


def jax_packs(log_n, primes, pallas):
    """{name: pack} for the JAX backends, built explicitly (the library's
    default pack depends on TROY_NTT_BACKEND)."""
    mods = [JModulus(p) for p in primes]
    tabs = JNTT.NTTTables(log_n, mods)
    radix2 = {k: jnp.asarray(v) for k, v in tabs.host.items()}
    sixstep = dict(radix2, **tabs._sixstep_pack())
    packs = {"radix2": radix2, "sixstep": sixstep}
    if pallas:
        packs["pallas"] = sixstep
        packs["pallas_mxu"] = dict(sixstep, **MxuNTTTables(log_n, mods).pack_prefixed())
    return packs


FORWARD = {"radix2": JNTT.ntt_forward, "sixstep": JNTT.ntt_forward,
           "pallas": ntt_forward_pallas, "pallas_mxu": ntt_forward_pallas_mxu}
INVERSE = {"radix2": JNTT.ntt_inverse, "sixstep": JNTT.ntt_inverse,
           "pallas": ntt_inverse_pallas, "pallas_mxu": ntt_inverse_pallas_mxu}


def residues(shape, primes, factor=1):
    q = np.array(primes, dtype=np.uint64)[:, None]
    return (RNG.integers(0, 1 << 62, size=shape, dtype=np.uint64) % (factor * q)
            ).astype(np.uint32)


def check(log_n, L, lead, pallas):
    n = 1 << log_n
    primes = numth.get_primes(2 * n, 30, L)
    tt = TNTT.NTTTables(log_n, [Modulus(p) for p in primes], "cpu")
    packs = jax_packs(log_n, primes, pallas)
    lazy = residues((*lead, L, n), primes, factor=2)   # forward takes [0, 2q)
    canon = residues((*lead, L, n), primes)
    fwd = TNTT.ntt_forward(torch.from_numpy(lazy.astype(np.int64)), tt).numpy()
    inv = TNTT.ntt_inverse(torch.from_numpy(canon.astype(np.int64)), tt).numpy()
    for name, pack in packs.items():
        np.testing.assert_array_equal(
            np.asarray(FORWARD[name](jnp.asarray(lazy), pack)), fwd, err_msg=name)
        np.testing.assert_array_equal(
            np.asarray(INVERSE[name](jnp.asarray(canon), pack)), inv, err_msg=name)
    back = TNTT.ntt_inverse(torch.from_numpy(fwd), tt).numpy()
    np.testing.assert_array_equal(back, lazy % np.array(primes, np.uint32)[:, None])


def test_ntt_matches_every_jax_backend():
    check(9, 2, (2,), pallas=True)


@pytest.mark.parametrize("log_n,L,lead", [(10, 3, (2, 2)), (11, 1, (1,))])
def test_ntt_matches_xla_backends(log_n, L, lead):
    check(log_n, L, lead, pallas=False)


def test_ntt_flagship_size():
    """n = 8192 over 7 primes against the radix-2 and six-step transforms."""
    check(13, 7, (1,), pallas=False)


def test_ntt_small_degree_radix2():
    """n < 256, where the JAX package has only the radix-2 transform."""
    check(4, 3, (3,), pallas=False)


def test_ntt_order_is_brv_odd_powers():
    """Position p of the forward NTT holds the evaluation at psi^(2 brv(p)+1)."""
    log_n, q = 5, numth.get_prime(64, 30)
    n = 1 << log_n
    tt = TNTT.NTTTables(log_n, [Modulus(q)], "cpu")
    psi = numth.try_minimal_primitive_root(2 * n, q)
    coeffs = RNG.integers(0, q, size=n)
    got = TNTT.ntt_forward(torch.tensor(coeffs)[None], tt)[0].tolist()
    for p in range(n):
        x = pow(psi, 2 * numth.reverse_bits(p, log_n) + 1, q)
        assert got[p] == sum(int(c) * pow(x, i, q) for i, c in enumerate(coeffs)) % q


def test_take_selects_limb_rows():
    primes = numth.get_primes(2 * 64, 30, 3)
    tt = TNTT.NTTTables(6, [Modulus(p) for p in primes], "cpu")
    sub = tt.take([2, 0])
    assert [m.value for m in sub.moduli] == [primes[2], primes[0]]
    x = torch.from_numpy(residues((2, 64), [primes[2], primes[0]]).astype(np.int64))
    ref = TNTT.NTTTables(6, [Modulus(primes[2]), Modulus(primes[0])], "cpu")
    assert torch.equal(TNTT.ntt_forward(x, sub), TNTT.ntt_forward(x, ref))
    assert torch.equal(sub.kernel_rows, ref.kernel_rows)
    assert torch.equal(sub.kernel_scalars, ref.kernel_scalars)


def test_kernel_wrapper_refuses_cpu_tensors():
    """The CUDA wrapper launches or raises; it never computes on the CPU."""
    tt = TNTT.NTTTables(4, [Modulus(numth.get_prime(32, 30))], "cpu")
    x = torch.zeros(1, 16, dtype=torch.int64)
    for fn in (ntt_cuda.ntt_forward, ntt_cuda.ntt_inverse):
        with pytest.raises(ValueError):
            fn(x, tt)
    assert ntt_cuda.LAUNCHES == {"ntt_forward": 0, "ntt_inverse": 0}
