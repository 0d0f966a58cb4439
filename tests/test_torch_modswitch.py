"""BFV mod switch and special-prime encryption of the port against the JAX
package, bit for bit: divide_and_round_q_last, mod_switch_to_next /
mod_switch_to and the batched mod-switch step, rotation after a mod switch
(the keyswitch picking the key rows of the lower level), and special-prime
encryption with injected randomness, symmetric and public-key."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from troy_tpu.core import encryptor as JENC
from troy_tpu.core.encryptor import Encryptor as JEncryptor
from troy_tpu.core.rlwe import (_symmetric_combine as j_symmetric_combine,
                                _asymmetric_combine as j_asymmetric_combine)
from troy_tpu.ops.galois import GaloisTool as JGalois
from troy_tpu.parallel.batched import BatchedEvaluator as JBatched
from troy_tpu_torch import interop
from troy_tpu_torch.core import encryptor as ENC
from troy_tpu_torch.core.encryptor import Encryptor
from troy_tpu_torch.core.keygen import KeyGenerator
from troy_tpu_torch.core.rlwe import _symmetric_combine, _asymmetric_combine
from troy_tpu_torch.parallel.batched import BatchedEvaluator

from .test_torch_client import Both, N, same

RNG = np.random.default_rng(41)


@pytest.fixture(scope="module")
def flow():
    both = Both()
    msgs = both.messages(2, RNG)
    elt = JGalois.get_element_from_step(1, N)
    jglk = both.jkg.create_galois_keys_from_elements([elt])
    glk = interop.galois_keys({g: np.asarray(k) for g, k in jglk.keys.items()},
                              both.tc.key_parms_id, "cpu")
    return dict(both=both, msgs=msgs, jcts=both.jax_cts(msgs), jglk=jglk, glk=glk)


@pytest.mark.parametrize("depth", [0, 1, 2])
def test_divide_and_round_q_last(flow, depth):
    """At the key level (the special-prime division), the first and the
    second level; the last limb's first residues are 0, 1, q/2 - 1/2,
    q/2 + 1/2 and q - 1, around the rounding threshold."""
    both = flow["both"]
    jcd = both.jc.key_context_data()
    for _ in range(depth):
        jcd = jcd.next
    tcd = both.tc.get_context_data(jcd.parms_id)
    x = both.residues(jcd, (2, 2))
    x[..., -1, :5] = [0, 1, jcd.base_q.values[-1] // 2, jcd.base_q.values[-1] // 2 + 1,
                      jcd.base_q.values[-1] - 1]
    j = jcd.rns_tool.divide_and_round_q_last(jnp.asarray(x))
    t = tcd.rns_tool.divide_and_round_q_last(interop.to_tensor(x, "cpu"))
    assert tuple(t.shape) == (2, 2, tcd.coeff_modulus_size - 1, N)
    same(j, t)


def test_mod_switch_to_next_and_to(flow):
    both, jct = flow["both"], flow["jcts"][0]
    ct = both.port(jct)
    jnext, nxt = both.jev.mod_switch_to_next(jct), both.ev.mod_switch_to_next(ct)
    assert nxt.parms_id == jnext.parms_id == both.tc.first_context_data().next.parms_id
    same(jnext.data, nxt.data)
    np.testing.assert_array_equal(both.decode(nxt), flow["msgs"][0].astype(np.int64))
    last = both.tc.last_parms_id
    jlast, tlast = both.jev.mod_switch_to(jct, last), both.ev.mod_switch_to(ct, last)
    assert tlast.parms_id == jlast.parms_id == last and tlast.data.shape[-2] == 1
    same(jlast.data, tlast.data)
    np.testing.assert_array_equal(both.decode(tlast), flow["msgs"][0].astype(np.int64))
    assert both.tc.get_context_data(last).is_last()
    assert both.tc.get_context_data(last).chain_index == both.jc.get_context_data(
        last).chain_index == 3
    with pytest.raises(ValueError, match="last level"):
        both.ev.mod_switch_to_next(tlast)
    with pytest.raises(ValueError, match="cannot reach"):
        both.ev.mod_switch_to(tlast, both.tc.first_parms_id)
    assert both.ev.mod_switch_to(ct, ct.parms_id) is ct


def test_batched_mod_switch_step(flow):
    both = flow["both"]
    jcd, tcd = both.jc.first_context_data(), both.tc.first_context_data()
    d = np.stack([np.asarray(c.data) for c in flow["jcts"]])
    want = np.asarray(jax.jit(JBatched(both.jev, jcd).build_mod_switch_step())(jnp.asarray(d)))
    got = BatchedEvaluator(both.ev, tcd).build_mod_switch_step()(interop.to_tensor(d, "cpu"))
    np.testing.assert_array_equal(interop.to_numpy(got), want)
    with pytest.raises(ValueError, match="last level"):
        BatchedEvaluator(both.ev, both.tc.get_context_data(both.tc.last_parms_id)
                         ).build_mod_switch_step()


def test_rotate_after_mod_switch(flow):
    """rotate_rows(1) at level L - 1, object API and batched step, with the
    JAX Galois keys: the keyswitch takes key rows 0..L-2 and the special
    prime's."""
    both = flow["both"]
    jct = both.jev.mod_switch_to_next(flow["jcts"][1])
    ct = both.port(jct)
    out = both.ev.rotate_rows(ct, 1, flow["glk"])
    same(both.jev.rotate_rows(jct, 1, flow["jglk"]).data, out.data)
    rows = flow["msgs"][1].astype(np.int64).reshape(2, N // 2)
    np.testing.assert_array_equal(both.decode(out), np.roll(rows, -1, axis=1).reshape(N))
    jcd = both.jc.get_context_data(jct.parms_id)
    jstep, elts = JBatched(both.jev, jcd).build_rotate_rows_step(1)
    step, _ = BatchedEvaluator(both.ev, both.tc.get_context_data(ct.parms_id)
                               ).build_rotate_rows_step(1)
    d = np.asarray(jct.data)[None]
    want = np.asarray(jax.jit(jstep)(jnp.asarray(d), (flow["jglk"].key(elts[0]),)))
    got = step(interop.to_tensor(d, "cpu"), (flow["glk"].key(elts[0]),))
    np.testing.assert_array_equal(interop.to_numpy(got), want)


@pytest.fixture(scope="module")
def special():
    return Both(special_prime=True)


@pytest.mark.parametrize("kind", ["symmetric", "asymmetric"])
def test_special_prime_encryption(special, monkeypatch, kind):
    """Encryption at the key level with injected randomness, divided by the
    special prime, plus scale_up(m) at the first level: the JAX Encryptor
    and the port's, with each package's zero encryption replaced by its
    combine of the same numpy-made randomness."""
    both = special
    kcd, tkcd = both.jc.key_context_data(), both.tc.key_context_data()
    e = [both.lift(kcd, RNG.integers(-21, 22, size=N)) for _ in range(2)]
    jpk = both.jkg.create_public_key()
    pk = interop.public_key(np.asarray(jpk.data()), jpk.parms_id, "cpu")
    if kind == "symmetric":
        a = both.residues(kcd, ())
        jzero = j_symmetric_combine(kcd, both.jkg.secret_key.data, jnp.asarray(a),
                                    jnp.asarray(e[0]), False)
        tzero = _symmetric_combine(tkcd, both.sk.data, interop.to_tensor(a, "cpu"),
                                   interop.to_tensor(e[0], "cpu"), False)
    else:
        u = both.lift(kcd, RNG.integers(-1, 2, size=N))
        jzero = j_asymmetric_combine(kcd, jpk.data(), jnp.asarray(u), jnp.asarray(e[0]),
                                     jnp.asarray(e[1]), False)
        tzero = _asymmetric_combine(tkcd, pk.data(), *(interop.to_tensor(v, "cpu")
                                                       for v in (u, e[0], e[1])), False)
    name = f"encrypt_zero_{kind}"

    def fixed(zero):
        def fn(cd, *args, **kwargs):
            assert cd.parms_id == both.jc.key_parms_id
            return zero
        return fn

    monkeypatch.setattr(JENC, name, fixed(jzero))
    monkeypatch.setattr(ENC, name, fixed(tzero))
    m = both.messages(1, RNG)[0]
    jencr = JEncryptor(both.jc, pk=jpk, sk=both.jkg.secret_key)
    encr = Encryptor(both.tc, both.sk, torch.Generator(), pk=pk)
    jct = getattr(jencr, f"encrypt_{kind}")(both.jenc.encode(m))
    ct = getattr(encr, f"encrypt_{kind}")(both.tenc.encode(m))
    assert ct.parms_id == jct.parms_id == both.tc.first_parms_id
    same(jct.data, ct.data)
    np.testing.assert_array_equal(both.decode(ct), m.astype(np.int64))


@pytest.mark.parametrize("kind", ["symmetric", "asymmetric"])
def test_special_prime_encryption_decrypts_in_both_packages(special, kind):
    """Special-prime encryption under the port's own randomness."""
    both = special
    m = both.messages(1, RNG)[0]
    gen = torch.Generator().manual_seed(5)
    pk = KeyGenerator(both.tc, gen, sk=both.sk).create_public_key()
    encr = Encryptor(both.tc, both.sk, gen, pk=pk)
    ct = getattr(encr, f"encrypt_{kind}")(both.tenc.encode(m))
    assert ct.parms_id == both.tc.first_parms_id and ct.data.shape[-2] == 3
    np.testing.assert_array_equal(both.decode(ct), m.astype(np.int64))
    np.testing.assert_array_equal(both.jax_decode(ct), m.astype(np.int64))
    assert both.dec.invariant_noise_budget(ct) > 0
