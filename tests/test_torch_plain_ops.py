"""The port's translate, plaintext and NTT-form operations against the JAX
package, bit for bit, on ciphertexts made by the JAX package: negate, sub and
add (a size-3 plus a size-2 ciphertext in both orders, and NTT-form
operands), add_plain / sub_plain and multiply_plain in every plaintext form,
square, the NTT transforms, bfv_scale_up / bfv_centralize, centralize and
decentralize, the broadcast products and negacyclic_shift, relinearize of an
NTT-form ciphertext, apply_keyswitching, and the batched add and square +
relinearize step."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from troy_tpu.ops import dyadic as JD, poly as JP
from troy_tpu.parallel.batched import BatchedEvaluator as JBatched
from troy_tpu_torch import interop
from troy_tpu_torch.core.keys import KSwitchKeys
from troy_tpu_torch.core.plaintext import Plaintext
from troy_tpu_torch.ops import dyadic as D, poly as P
from troy_tpu_torch.parallel.batched import BatchedEvaluator

from .test_torch_client import Both, N, same, same_ct

RNG = np.random.default_rng(53)


@pytest.fixture(scope="module")
def flow():
    both = Both()
    msgs = both.messages(3, RNG)
    jcts = both.jax_cts(msgs)
    jprod = both.jev.multiply(jcts[0], jcts[1])
    rlk = both.jkg.create_relin_keys()
    keys = interop.relin_keys({k: np.asarray(v) for k, v in rlk.keys.items()},
                              both.tc.key_parms_id, "cpu")
    return dict(both=both, msgs=msgs, jcts=jcts, jprod=jprod, rlk=rlk, keys=keys)


def plains(both, m):
    """(JAX, port) pairs of one message in each plaintext form: mod t, the
    RNS scale-up and centred forms, and the NTT form at the first level."""
    pid = both.tc.first_parms_id
    jp = both.jenc.encode(m)
    tp = both.tenc.encode(m)
    return {
        "mod t": (jp, tp),
        "scale_up": (both.jev.bfv_scale_up(jp, pid), both.ev.bfv_scale_up(tp, pid)),
        "centralize": (both.jev.bfv_centralize(jp, pid), both.ev.bfv_centralize(tp, pid)),
        "ntt": (both.jev.transform_plain_to_ntt(jp, pid), both.ev.transform_plain_to_ntt(tp, pid)),
    }


def test_plaintext_forms(flow):
    both = flow["both"]
    for form, (jp, tp) in plains(both, flow["msgs"][2]).items():
        same(jp.data, tp.data)
        assert tp.is_ntt_form == bool(jp.is_ntt_form), form


@pytest.mark.parametrize("order", ["3 + 2", "2 + 3"])
def test_add_pads_the_smaller_ciphertext(flow, order):
    """F1: a size-3 product plus a size-2 ciphertext, in both orders."""
    both, jprod, jct = flow["both"], flow["jprod"], flow["jcts"][2]
    pair = (jprod, jct) if order == "3 + 2" else (jct, jprod)
    out = both.ev.add(*(both.port(c) for c in pair))
    assert out.size == 3
    same_ct(both.jev.add(*pair), out)
    want = (flow["msgs"][0].astype(object) * flow["msgs"][1] + flow["msgs"][2]) % both.t
    np.testing.assert_array_equal(both.decode(out), want.astype(np.int64))


def test_add_ntt_form(flow):
    """F2: two NTT-form ciphertexts add; mixed forms raise."""
    both = flow["both"]
    ja, jb = (both.jev.transform_to_ntt(c) for c in flow["jcts"][:2])
    ta, tb = (both.ev.transform_to_ntt(both.port(c)) for c in flow["jcts"][:2])
    same_ct(ja, ta)
    out = both.ev.add(ta, tb)
    same_ct(both.jev.add(ja, jb), out)
    back = both.ev.transform_from_ntt(out)
    same_ct(both.jev.transform_from_ntt(both.jev.add(ja, jb)), back)
    np.testing.assert_array_equal(
        both.decode(back), ((flow["msgs"][0] + flow["msgs"][1]) % both.t).astype(np.int64))
    with pytest.raises(ValueError, match="NTT form"):
        both.ev.add(ta, both.port(flow["jcts"][1]))
    with pytest.raises(ValueError, match="coeff form"):
        both.ev.multiply(ta, tb)
    with pytest.raises(ValueError, match="already NTT"):
        both.ev.transform_to_ntt(ta)
    with pytest.raises(ValueError, match="not NTT"):
        both.ev.transform_from_ntt(back)


@pytest.mark.parametrize("op", ["negate", "sub", "square"])
def test_translate_and_square(flow, op):
    both = flow["both"]
    ja, jb = flow["jcts"][:2]
    ta, tb = both.port(ja), both.port(jb)
    if op == "negate":
        same_ct(both.jev.negate(ja), both.ev.negate(ta))
    elif op == "sub":
        out = both.ev.sub(ta, tb)
        same_ct(both.jev.sub(ja, jb), out)
        np.testing.assert_array_equal(
            both.decode(out),
            ((flow["msgs"][0].astype(np.int64) - flow["msgs"][1].astype(np.int64)) % both.t))
    else:
        out = both.ev.square(ta)
        same_ct(both.jev.square(ja), out)
        np.testing.assert_array_equal(
            both.decode(out), ((flow["msgs"][0].astype(object) ** 2) % both.t).astype(np.int64))


@pytest.mark.parametrize("subtract", [False, True])
@pytest.mark.parametrize("form", ["mod t", "scale_up", "ntt"])
def test_add_sub_plain(flow, form, subtract):
    """ct +- plain: a mod-t or scale-up plaintext on a coefficient-form ct,
    an NTT-form plaintext on an NTT-form ct (the JAX package adds the
    centred lift there, unscaled, and so does the port)."""
    both = flow["both"]
    jp, tp = plains(both, flow["msgs"][2])[form]
    jct, ct = flow["jcts"][0], both.port(flow["jcts"][0])
    if form == "ntt":
        jct, ct = both.jev.transform_to_ntt(jct), both.ev.transform_to_ntt(ct)
    name = "sub_plain" if subtract else "add_plain"
    out = getattr(both.ev, name)(ct, tp)
    same_ct(getattr(both.jev, name)(jct, jp), out)
    if form != "ntt":
        sign = -1 if subtract else 1
        want = (flow["msgs"][0].astype(np.int64) + sign * flow["msgs"][2].astype(np.int64))
        np.testing.assert_array_equal(both.decode(out), want % both.t)


def test_add_plain_refusals(flow):
    both = flow["both"]
    ct = both.port(flow["jcts"][0])
    tp = plains(both, flow["msgs"][2])
    with pytest.raises(ValueError, match="NTT form"):
        both.ev.add_plain(ct, tp["ntt"][1])
    other = Plaintext(tp["scale_up"][1].data, parms_id=both.tc.key_parms_id)
    with pytest.raises(ValueError, match="level"):
        both.ev.add_plain(ct, other)
    with pytest.raises(ValueError, match="level"):
        both.ev.multiply_plain(ct, other)


@pytest.mark.parametrize("case", ["coeff ct, mod t", "coeff ct, centralize",
                                  "coeff ct, ntt", "ntt ct, ntt", "ntt ct, mod t"])
def test_multiply_plain(flow, case):
    both = flow["both"]
    ct_form, form = case.split(", ")
    jp, tp = plains(both, flow["msgs"][2])[form]
    jct, ct = flow["jcts"][0], both.port(flow["jcts"][0])
    if ct_form == "ntt ct":
        jct, ct = both.jev.transform_to_ntt(jct), both.ev.transform_to_ntt(ct)
    out = both.ev.multiply_plain(ct, tp)
    same_ct(both.jev.multiply_plain(jct, jp), out)
    if out.is_ntt_form:
        out = both.ev.transform_from_ntt(out)
    want = (flow["msgs"][0].astype(object) * flow["msgs"][2]) % both.t
    np.testing.assert_array_equal(both.decode(out), want.astype(np.int64))


def test_centralize_decentralize(flow):
    both = flow["both"]
    jcd, tcd = both.jc.first_context_data(), both.tc.first_context_data()
    m = RNG.integers(0, both.t, size=(2, N)).astype(np.uint32)
    m[0, :4] = [0, 1, both.t // 2, both.t // 2 + 1]
    lifted = tcd.scaler.centralize(interop.to_tensor(m, "cpu"))
    same(jcd.scaler.centralize(jnp.asarray(m)), lifted)
    same(jcd.scaler.decentralize(jcd.scaler.centralize(jnp.asarray(m))),
         tcd.scaler.decentralize(lifted))
    np.testing.assert_array_equal(tcd.scaler.decentralize(lifted).numpy(), m)


def test_broadcast_products_and_shift(flow):
    both = flow["both"]
    jcd, tcd = both.jc.first_context_data(), both.tc.first_context_data()
    a, acc = both.residues(jcd, (2, 3)), both.residues(jcd, (2, 3))
    plain = both.residues(jcd, ())
    ja, jplain, jacc = (jnp.asarray(v) for v in (a, plain, acc))
    ta, tplain, tacc = (interop.to_tensor(v, "cpu") for v in (a, plain, acc))
    qtab, jq = tcd.qtab(), jcd.qtab()
    same(JD.dyadic_broadcast_product(ja, jplain, jq),
         D.dyadic_broadcast_product(ta, tplain, qtab))
    same(JD.dyadic_broadcast_product_accumulate(ja, jplain, jacc, jq),
         D.dyadic_broadcast_product_accumulate(ta, tplain, tacc, qtab))
    for shift in (0, 1, 5, N - 1, N, N + 3, 2 * N - 1, -1, 3 * N + 2):
        same(JP.negacyclic_shift(ja, shift, jq), P.negacyclic_shift(ta, shift, qtab))


def test_relinearize_ntt_form(flow):
    both = flow["both"]
    jprod = both.jev.transform_to_ntt(flow["jprod"])
    prod = both.ev.transform_to_ntt(both.port(flow["jprod"]))
    out = both.ev.relinearize(prod, flow["keys"])
    same_ct(both.jev.relinearize(jprod, flow["rlk"]), out)
    want = (flow["msgs"][0].astype(object) * flow["msgs"][1]) % both.t
    np.testing.assert_array_equal(both.decode(both.ev.transform_from_ntt(out)),
                                  want.astype(np.int64))


@pytest.mark.parametrize("ntt_form", [False, True])
def test_apply_keyswitching(flow, ntt_form):
    """A JAX-made key from the JAX secret to a new one: the port's switch
    equals the JAX switch and decrypts under the new key in both packages."""
    both = flow["both"]
    from troy_tpu.core.keygen import KeyGenerator as JKeyGen

    new = JKeyGen(both.jc, prng=both.jkg.prng)
    jksk = both.jkg.create_keyswitching_key(new.secret_key)
    ksk = KSwitchKeys({0: interop.to_tensor(np.asarray(jksk.get(0)), "cpu")},
                      both.tc.key_parms_id)
    jct, ct = flow["jcts"][1], both.port(flow["jcts"][1])
    if ntt_form:
        jct, ct = both.jev.transform_to_ntt(jct), both.ev.transform_to_ntt(ct)
    out = both.ev.apply_keyswitching(ct, ksk)
    same_ct(both.jev.apply_keyswitching(jct, jksk), out)
    if ntt_form:
        out = both.ev.transform_from_ntt(out)
    new_sk = interop.secret_key(np.asarray(new.secret_key.data), both.tc.key_parms_id, "cpu")
    np.testing.assert_array_equal(both.jax_decode(out, new_sk),
                                  flow["msgs"][1].astype(np.int64))


def test_port_keyswitching_key(flow):
    """create_keyswitching_key in the port switches to the new secret."""
    from troy_tpu_torch.core.keygen import KeyGenerator
    from troy_tpu_torch.core.decryptor import Decryptor

    both = flow["both"]
    gen = torch.Generator().manual_seed(3)
    new = KeyGenerator(both.tc, gen)
    ksk = KeyGenerator(both.tc, gen, sk=both.sk).create_keyswitching_key(new.secret_key)
    assert tuple(ksk.get(0).shape) == (3, 2, 4, N)
    out = both.ev.apply_keyswitching(both.port(flow["jcts"][0]), ksk)
    got = both.tenc.decode(Decryptor(both.tc, new.secret_key).decrypt(out)).numpy()
    np.testing.assert_array_equal(got, flow["msgs"][0].astype(np.int64))


def test_batched_add_and_square_relin_step(flow):
    both = flow["both"]
    jcd, tcd = both.jc.first_context_data(), both.tc.first_context_data()
    d = np.stack([np.asarray(c.data) for c in flow["jcts"][:2]])
    jb, tb = JBatched(both.jev, jcd), BatchedEvaluator(both.ev, tcd)
    td = interop.to_tensor(d, "cpu")
    same(jb.add(jnp.asarray(d), jnp.asarray(d[::-1].copy())), tb.add(td, td.flip(0)))
    key = flow["rlk"].key(2)
    want = jax.jit(jb.build_square_relin_step(key))(jnp.asarray(d), key)
    got = tb.build_square_relin_step(flow["keys"].key(2))(td, flow["keys"].key(2))
    same(want, got)
    for b in range(2):
        ct = interop.ciphertext(interop.to_numpy(got[b]), tcd.parms_id, "cpu")
        np.testing.assert_array_equal(
            both.decode(ct), ((flow["msgs"][b].astype(object) ** 2) % both.t).astype(np.int64))
