"""The port's serialization (troy_tpu_torch/utils/serialize.py) against the
JAX package's, byte for byte, for every object and the modes Nil, Zlib and
Zstd: port.save(x) == jax.save(x_jax); port.load(jax bytes) equals the
port's object; jax.load(port bytes) equals the JAX object.  Objects come from
tests/test_torch_seeded.py's Seeded pairs (n = 1024, 4 x 30-bit primes, the
context's default threefry streams), so they are equal in both packages to
begin with: plaintexts, ciphertexts (plain, seeded with a seed above 2^32,
size 3, sparse terms in coefficient and NTT form), secret and public keys
(seeded), switching keys, LWE samples and parameters.  Also the size upper
bounds, the raw fallback without libzstd and the refusals.  Tolerance 0
throughout."""

import numpy as np
import pytest
import torch

from troy_tpu.core.evaluator import Evaluator as JEvaluator
from troy_tpu.utils import serialize as JS
from troy_tpu_torch import interop
from troy_tpu_torch.core.ciphertext import Ciphertext
from troy_tpu_torch.core.evaluator import Evaluator
from troy_tpu_torch.utils import serialize as S

from .test_torch_client import same
from .test_torch_seeded import Seeded, same_ct, same_keys

MODES = [S.CompressionMode.Nil, S.CompressionMode.Zlib, S.CompressionMode.Zstd]


class Objects:
    """Equal objects of one scheme in both packages."""

    def __init__(self, scheme: str):
        self.p = p = Seeded(scheme)
        self.jpk, self.pk = p.jkg.create_public_key(True), p.kg.create_public_key(True)
        self.jencr, self.encr = p.encryptors(self.jpk, self.pk)
        self.jrlk, self.rlk = p.jkg.create_relin_keys(), p.kg.create_relin_keys()
        self.jglk = p.jkg.create_galois_keys_from_elements([3, 2 * 1024 - 1])
        self.glk = p.kg.create_galois_keys_from_elements([3, 2 * 1024 - 1])
        self.jpt, self.pt = p.encode(p.message())
        self.jev, self.ev = JEvaluator(p.jc), Evaluator(p.tc)

    def cts(self, save_seed: bool):
        jct = self.jencr.encrypt_symmetric(self.jpt, save_seed=save_seed)
        ct = self.encr.encrypt_symmetric(self.pt, save_seed=save_seed)
        same_ct(jct, ct)
        return jct, ct


@pytest.fixture(scope="module", params=["BFV", "CKKS", "BGV"])
def O(request):
    return Objects(request.param)


def both_ways(jsave, save, jload, load, jx, x, check):
    """Equal bytes, and each package loads the other's."""
    jb, b = jsave(jx), save(x)
    assert b == jb
    check(jx, load(jb))
    check(jload(b), x)
    return b


def same_pt(jpt, pt):
    same(jpt.data, pt.data)
    assert (pt.parms_id, pt.is_ntt_form, pt.scale, pt.coeff_count) == \
        (jpt.parms_id, bool(jpt.is_ntt_form), jpt.scale, jpt.coeff_count)


def same_sk(jsk, sk):
    same(jsk.data, sk.data)
    assert sk.parms_id == jsk.parms_id


def same_loaded_ct(jct, ct):
    """A loaded ciphertext has no seed: compare all but the seed."""
    same(jct.data, ct.data)
    assert (ct.parms_id, ct.is_ntt_form, ct.scale, ct.correction_factor) == \
        (jct.parms_id, bool(jct.is_ntt_form), jct.scale, jct.correction_factor)


@pytest.mark.parametrize("mode", MODES)
def test_plaintext(O, mode):
    b = both_ways(lambda x: JS.save_plaintext(x, mode), lambda x: S.save_plaintext(x, mode),
                  JS.load_plaintext, lambda b: S.load_plaintext(b, O.p.tc),
                  O.jpt, O.pt, same_pt)
    assert S.load_plaintext(b, "cpu").data.device.type == "cpu"
    assert S.plaintext_size_upperbound(O.pt) == JS.plaintext_size_upperbound(O.jpt) >= len(b)


@pytest.mark.parametrize("save_seed", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_ciphertext(O, mode, save_seed):
    jct, ct = O.cts(save_seed)
    b = both_ways(lambda x: JS.save_ciphertext(x, O.p.jc, mode),
                  lambda x: S.save_ciphertext(x, O.p.tc, mode),
                  lambda b: JS.load_ciphertext(b, O.p.jc),
                  lambda b: S.load_ciphertext(b, O.p.tc), jct, ct, same_loaded_ct)
    loaded = S.load_ciphertext(b, O.p.tc)
    assert loaded.seed is None and bool((loaded.data == ct.data).all())
    assert S.ciphertext_size_upperbound(ct) == JS.ciphertext_size_upperbound(jct) >= len(b)
    if save_seed:
        assert ct.seed >= 1 << 32  # the wire keeps all 63 bits; c1 reads the low 32
        assert len(b) < len(S.save_ciphertext(S.load_ciphertext(b, O.p.tc), O.p.tc, mode))


def test_ciphertext_of_size_three(O):
    jct, ct = O.cts(False)
    j3, t3 = O.jev.multiply(jct, jct), O.ev.multiply(ct, ct)
    same(j3.data, t3.data)
    both_ways(lambda x: JS.save_ciphertext(x), lambda x: S.save_ciphertext(x),
              lambda b: JS.load_ciphertext(b, O.p.jc), lambda b: S.load_ciphertext(b, O.p.tc),
              j3, t3, same_loaded_ct)


@pytest.mark.parametrize("save_seed", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_terms(O, mode, save_seed):
    """Sparse c0: BFV in coefficient form, CKKS and BGV in NTT form (the
    inverse NTT before saving, the forward NTT after loading)."""
    jct, ct = O.cts(save_seed)
    terms = [0, 5, 17, 511, 1023]
    b = S.save_ciphertext(ct, O.p.tc, mode, terms=terms)
    assert b == JS.save_ciphertext(jct, O.p.jc, mode, terms=terms)
    same_loaded_ct(JS.load_ciphertext(b, O.p.jc), S.load_ciphertext(b, O.p.tc))


def test_public_key_and_secret_key(O):
    for mode in MODES:
        both_ways(lambda x: JS.save_public_key(x, O.p.jc, mode),
                  lambda x: S.save_public_key(x, O.p.tc, mode),
                  lambda b: JS.load_public_key(b, O.p.jc),
                  lambda b: S.load_public_key(b, O.p.tc), O.jpk, O.pk,
                  lambda j, t: same_loaded_ct(j.ciphertext, t.ciphertext))
        both_ways(lambda x: JS.save_secret_key(x, mode), lambda x: S.save_secret_key(x, mode),
                  JS.load_secret_key, lambda b: S.load_secret_key(b, O.p.tc),
                  O.p.jkg.secret_key, O.p.kg.secret_key, same_sk)
    assert S.public_key_size_upperbound(O.pk) == JS.public_key_size_upperbound(O.jpk)
    assert S.secret_key_size_upperbound(O.p.kg.secret_key) == \
        JS.secret_key_size_upperbound(O.p.jkg.secret_key)


@pytest.mark.parametrize("mode", MODES)
def test_switching_keys(O, mode):
    for jk, k, jload, load in ((O.jrlk, O.rlk, JS.load_relin_keys, S.load_relin_keys),
                               (O.jglk, O.glk, JS.load_galois_keys, S.load_galois_keys),
                               (O.jrlk, O.rlk, JS.load_kswitch_keys, S.load_kswitch_keys)):
        loaded = both_ways(lambda x: JS.save_kswitch_keys(x, mode),
                           lambda x: S.save_kswitch_keys(x, mode), jload,
                           lambda b: load(b, O.p.tc), jk, k, same_keys)
        assert type(load(loaded, "cpu")).__name__ == type(jload(loaded)).__name__
        assert S.kswitch_keys_size_upperbound(k) == JS.kswitch_keys_size_upperbound(jk)


def same_lwe(jl, lwe):
    same(jl.c0, lwe.c0)
    same(jl.c1, lwe.c1)
    assert (lwe.parms_id, lwe.scale, lwe.correction_factor) == \
        (jl.parms_id, jl.scale, jl.correction_factor)


def test_lwe(O):
    jct, ct = O.cts(False)
    jl, lwe = O.jev.extract_lwe(jct, 7), O.ev.extract_lwe(ct, 7)
    for mode in MODES:
        both_ways(lambda x: JS.save_lwe(x, mode), lambda x: S.save_lwe(x, mode), JS.load_lwe,
                  lambda b: S.load_lwe(b, O.p.tc), jl, lwe,
                  same_lwe)
    assert S.lwe_size_upperbound(lwe) == JS.lwe_size_upperbound(jl)


@pytest.mark.parametrize("scheme", ["BFV", "CKKS", "BGV"])
def test_parms(scheme):
    p = Seeded(scheme, special_prime=scheme == "BGV")
    jparms = p.jc.key_context_data().parms
    parms = p.tc.key_context_data().parms
    for mode in MODES:
        b = S.save_parms(parms, mode)
        assert b == JS.save_parms(jparms, mode)
        back = S.load_parms(b)
        assert back.parms_id == parms.parms_id and JS.load_parms(b).parms_id == jparms.parms_id
        assert back.use_special_prime_for_encryption == parms.use_special_prime_for_encryption
    assert S.parms_size_upperbound(parms) == JS.parms_size_upperbound(jparms)


def test_frames_and_the_raw_fallback(monkeypatch):
    payload = bytes(range(256)) * 64
    for mode in MODES:
        frame = S.compress(payload, mode)
        assert frame == JS.compress(payload, mode) and frame[0] == int(mode)
        assert S.decompress(frame) == (payload, len(frame))
    noise = np.random.default_rng(1).bytes(4096)  # incompressible: written raw
    assert S.compress(noise, S.CompressionMode.Zstd)[0] == S.CompressionMode.Nil
    zstd_frame = S.compress(payload, S.CompressionMode.Zstd)
    monkeypatch.setattr(S, "_zstd", False)  # libzstd reported missing
    assert S.compress(payload, S.CompressionMode.Zstd) == S.compress(payload)
    with pytest.raises(RuntimeError, match="libzstd unavailable"):
        S.decompress(zstd_frame)


def test_refusals(O):
    jct, ct = O.cts(True)
    grown = Ciphertext(torch.cat([ct.data, ct.data[:1]]), ct.parms_id, ct.is_ntt_form,
                       seed=ct.seed)
    with pytest.raises(ValueError, match="seeded ciphertext must be size 2"):
        S.save_ciphertext(grown)
    with pytest.raises(ValueError, match="save_terms requires context"):
        S.save_ciphertext(ct, None, terms=[0, 1])
    bad = interop.ciphertext(np.zeros((2, 3, 4), np.uint32), ct.parms_id, "cpu")
    bad.data = bad.data - 1
    with pytest.raises(ValueError, match="outside u32"):
        S.save_ciphertext(bad)


def test_an_operation_drops_the_seed():
    """A seeded ciphertext's operated copy has no seed in the port, so it
    saves whole and loads right.  The JAX package keeps the stale seed: its
    negated copy saves as (c0, seed), reloads with the original c1 and
    decrypts wrong (the reference fault, ROADMAP §C)."""
    from troy_tpu.core.decryptor import Decryptor as JDecryptor

    p = Seeded("BFV")
    jencr, encr = p.encryptors()
    m = p.message()
    jpt, pt = p.encode(m)
    neg = Evaluator(p.tc).negate(encr.encrypt_symmetric(pt, save_seed=True))
    assert neg.seed is None and neg.clone().seed is None
    want = (-m.astype(np.int64)) % p.t
    back = S.load_ciphertext(S.save_ciphertext(neg, p.tc), p.tc)
    np.testing.assert_array_equal(p.cod.decode(p.dec.decrypt(back)).numpy(), want)
    jneg = JEvaluator(p.jc).negate(jencr.encrypt_symmetric(jpt, save_seed=True))
    assert jneg.seed is not None
    jback = JS.load_ciphertext(JS.save_ciphertext(jneg, p.jc), p.jc)
    got = p.jcod.decode(JDecryptor(p.jc, p.jkg.secret_key).decrypt(jback)).astype(np.int64)
    assert not np.array_equal(got, want)
