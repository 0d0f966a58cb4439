"""The port's host parameter layer and per-level tables equal the JAX
package's: primes, ParmsIDs, the modulus chain, NTT table rows, and the BFV
RNS tool's auxiliary bases and constants."""

import numpy as np
import pytest
import torch

from troy_tpu.core.params import EncryptionParameters as JParams, SchemeType as JScheme
from troy_tpu.core.coeff_modulus import (CoeffModulus as JCoeff, PlainModulus as JPlain,
                                         SecurityLevel as JSec)
from troy_tpu.core.context import HeContext as JContext
from troy_tpu_torch.core.params import EncryptionParameters, SchemeType
from troy_tpu_torch.core.coeff_modulus import CoeffModulus, PlainModulus, SecurityLevel
from troy_tpu_torch.core.context import HeContext

CASES = [(1024, [30, 30, 30, 30], 20), (2048, [29, 30, 29], 17), (8192, [30] * 7, 20)]


def contexts(n, bits, log_t):
    jp = JParams(JScheme.BFV).set_poly_modulus_degree(n)
    jp.set_coeff_modulus(JCoeff.create(n, bits)).set_plain_modulus(JPlain.batching(n, log_t))
    tp = EncryptionParameters(SchemeType.BFV).set_poly_modulus_degree(n)
    tp.set_coeff_modulus(CoeffModulus.create(n, bits)).set_plain_modulus(
        PlainModulus.batching(n, log_t))
    return (JContext.create(jp, True, JSec.Nil),
            HeContext.create(tp, sec_level=SecurityLevel.Nil, device="cpu"))


@pytest.mark.parametrize("n,bits,log_t", CASES)
def test_chain_primes_and_parms_ids(n, bits, log_t):
    jc, tc = contexts(n, bits, log_t)
    assert tc.key_parms_id == jc.key_parms_id
    assert tc.first_parms_id == jc.first_parms_id
    assert tc.last_parms_id == jc.last_parms_id
    jcd, tcd = jc.key_context_data(), tc.key_context_data()
    while jcd is not None:
        assert tcd.parms_id == jcd.parms_id
        assert tcd.base_q.values == jcd.base_q.values
        assert tcd.base_q.inv_punctured == jcd.base_q.inv_punctured
        jcd, tcd = jcd.next, tcd.next
    assert tcd is None


@pytest.mark.parametrize("n,bits,log_t", CASES[:2])
def test_ntt_rows_match(n, bits, log_t):
    jc, tc = contexts(n, bits, log_t)
    jh = jc.key_context_data().ntt_tables.host
    tt = tc.key_context_data().qtab()
    np.testing.assert_array_equal(tt.q.numpy(), jh["q"])
    np.testing.assert_array_equal(tt.psi_br.numpy(), jh["psi_br"])
    np.testing.assert_array_equal(tt.inv_psi_br.numpy(), jh["inv_psi_br"])
    np.testing.assert_array_equal(tt.n_inv.numpy(), jh["n_inv"])
    rows = tt.kernel_rows.numpy().view(np.uint32)
    for i, k in enumerate(("psi_br", "psi_br_shoup", "inv_psi_br", "inv_psi_br_shoup")):
        np.testing.assert_array_equal(rows[i], jh[k])
    sc = tt.kernel_scalars.numpy().view(np.uint32)
    for i, k in enumerate(("q", "n_inv", "n_inv_shoup")):
        np.testing.assert_array_equal(sc[i], jh[k])


@pytest.mark.parametrize("n,bits,log_t", CASES)
def test_rns_tool_bases_match(n, bits, log_t):
    jc, tc = contexts(n, bits, log_t)
    jt, tt = jc.first_context_data().rns_tool, tc.first_context_data().rns_tool
    assert tt.base_B.values == jt.base_B.values
    assert tt.base_Bsk.values == jt.base_Bsk.values
    assert tt.m_sk.value == jt.m_sk.value
    assert tt.gamma.value == jt.gamma.value
    assert tt.base_Bsk_m_tilde.values == jt.base_Bsk_m_tilde.values
    np.testing.assert_array_equal(tt.ff_tables.mat.numpy(), np.asarray(jt.ff_mat_qinv))
    np.testing.assert_array_equal(tt.ff_tables.ip.numpy(),
                                  np.asarray(jt.ff_inv_punc_t)[:, 0])
    for conv in ("conv_q_to_Bsk", "conv_q_to_Bsk_m_tilde", "conv_B_to_q",
                 "conv_B_to_m_sk", "conv_q_to_t_gamma"):
        np.testing.assert_array_equal(getattr(tt, conv).tables.mat.numpy(),
                                      np.asarray(getattr(jt, conv)._mat), err_msg=conv)
    np.testing.assert_array_equal(tt.hps_inv_q_f32.numpy(),
                                  np.asarray(jt.hps_inv_q_f32)[:, 0])
    np.testing.assert_array_equal(tt.bsk_ntt.psi_br.numpy(), jt.bsk_ntt.host["psi_br"])


def both_chains(expand, seed, n=64, bits=(30, 30, 30, 30), log_t=20):
    jp = JParams(JScheme.BFV).set_poly_modulus_degree(n)
    jp.set_coeff_modulus(JCoeff.create(n, list(bits))).set_plain_modulus(
        JPlain.batching(n, log_t))
    tp = EncryptionParameters(SchemeType.BFV).set_poly_modulus_degree(n)
    tp.set_coeff_modulus(CoeffModulus.create(n, list(bits))).set_plain_modulus(
        PlainModulus.batching(n, log_t))
    return (JContext.create(jp, expand, JSec.Nil, seed),
            HeContext.create(tp, expand, SecurityLevel.Nil, seed, device="cpu"))


@pytest.mark.parametrize("expand", [True, False])
@pytest.mark.parametrize("seed", [None, 1])
@pytest.mark.parametrize("bits", [(30, 30, 30, 30), (30,)])
def test_expand_mod_chain_matches_jax(expand, seed, bits):
    """HeContext.create(parms, expand_mod_chain, sec_level, seed): the chain's
    length, every level's parms_id and chain_index, first/last ids and
    using_keyswitching equal the JAX package's for both flag values."""
    jc, tc = both_chains(expand, seed, bits=bits)
    assert tc.seed == jc.seed == seed
    assert tc.using_keyswitching == jc.using_keyswitching
    assert (tc.key_parms_id, tc.first_parms_id, tc.last_parms_id) == \
        (jc.key_parms_id, jc.first_parms_id, jc.last_parms_id)
    jcd, tcd, levels = jc.key_context_data(), tc.key_context_data(), 0
    while jcd is not None:
        assert (tcd.parms_id, tcd.chain_index) == (jcd.parms_id, jcd.chain_index)
        assert tcd.is_last() == jcd.is_last()
        jcd, tcd, levels = jcd.next, tcd.next, levels + 1
    assert tcd is None
    assert sorted(tc._data) == sorted(jc._data)
    if len(bits) > 1:
        assert levels == (len(bits) if expand else 2)


def test_unexpanded_chain_has_one_data_level():
    """create(parms, False, Nil, 1, device="cpu"): the key level and one data
    level, which is both first and last."""
    _, tc = both_chains(False, 1)
    assert tc.first_context_data().is_last()
    assert tc.first_parms_id == tc.last_parms_id != tc.key_parms_id
    assert len(tc._data) == 2


@pytest.mark.parametrize("dev", ["cpu", torch.device("cpu")])
def test_positional_device_raises_type_error(dev):
    """The JAX package's second positional argument is the chain flag: a
    device there is refused, naming the device= keyword."""
    tp = EncryptionParameters(SchemeType.BFV).set_poly_modulus_degree(64)
    tp.set_coeff_modulus(CoeffModulus.create(64, [30, 30])).set_plain_modulus(
        PlainModulus.batching(64, 20))
    with pytest.raises(TypeError, match="device="):
        HeContext.create(tp, dev, SecurityLevel.Nil)


def test_default_device_needs_a_card(monkeypatch):
    """device=None means the CUDA card; with none present create raises and
    does not fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tp = EncryptionParameters(SchemeType.BFV).set_poly_modulus_degree(64)
    tp.set_coeff_modulus(CoeffModulus.create(64, [30, 30])).set_plain_modulus(
        PlainModulus.batching(64, 20))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        HeContext.create(tp, True, SecurityLevel.Nil)
