"""The port's LWE operations on the wide path (40-60-bit primes), checked by
decryption: the JAX package cannot be the oracle there, since its
extract_lwe reads qtab["q"], which the wide table pack lacks (pinned below
as a reference fault).

At n = 32 on CoeffModulus.create(32, [60, 40, 40, 60]) (t =
PlainModulus.batching(32, 20) for BFV and BGV, CKKS at scale 2^40), every
key and encryption from the context's default streams under one seed:
extract_lwe and assemble_lwe for terms 0, 1, 7 and 31, field_trace down to
coefficient 0, and pack_lwe_ciphertexts of 1, 3, 8 and 32 samples.  Each
result decrypts to the encrypted coefficients: exactly mod t for BFV and
BGV; for CKKS within CKKS_ATOL = 2^-28: the fresh noise is below 2^8 units
at scale 2^40, and the packing's merges and trace grow it by at most about
n / 2 = 2^4 (the largest error seen here is 2^-31.5)."""

import numpy as np
import pytest

from troy_tpu_torch.core.params import EncryptionParameters, SchemeType
from troy_tpu_torch.core.coeff_modulus import CoeffModulus, PlainModulus, SecurityLevel
from troy_tpu_torch.core.context import HeContext
from troy_tpu_torch.core.keygen import KeyGenerator
from troy_tpu_torch.core.encryptor import Encryptor
from troy_tpu_torch.core.decryptor import Decryptor
from troy_tpu_torch.core.evaluator import Evaluator
from troy_tpu_torch.core.batch_encoder import BatchEncoder
from troy_tpu_torch.core.ckks_encoder import CKKSEncoder

N, BITS, LOG_T, SEED, SCALE = 32, [60, 40, 40, 60], 20, 0x1DE, 2.0 ** 40
CKKS_ATOL = 2.0 ** -28


class WideLwe:
    """One scheme at [60, 40, 40, 60] in the port, its automorphism keys and
    one asymmetric encryption of random coefficients."""

    def __init__(self, scheme: str):
        self.scheme, self.ckks = scheme, scheme == "CKKS"
        p = EncryptionParameters(SchemeType[scheme]).set_poly_modulus_degree(N)
        p.set_coeff_modulus(CoeffModulus.create(N, BITS))
        if not self.ckks:
            p.set_plain_modulus(PlainModulus.batching(N, LOG_T))
            self.t = p.plain_modulus.value
        self.ctx = HeContext.create(p, True, SecurityLevel.Nil, SEED, device="cpu")
        assert self.ctx.first_context_data().wide
        kg = KeyGenerator(self.ctx)
        self.glk = kg.create_automorphism_keys()
        self.encr = Encryptor(self.ctx, pk=kg.create_public_key())
        self.dec = Decryptor(self.ctx, kg.secret_key)
        self.ev = Evaluator(self.ctx)
        self.enc = CKKSEncoder(self.ctx) if self.ckks else BatchEncoder(self.ctx)
        rng = np.random.default_rng(99)
        if self.ckks:
            self.coeffs = rng.uniform(-1, 1, N)
            pt = self.enc.encode_float64_polynomial(self.coeffs, scale=SCALE)
        else:
            self.coeffs = rng.integers(0, self.t, size=N, dtype=np.uint64)
            pt = self.enc.encode_polynomial(self.coeffs)
        self.ct = self.encr.encrypt_asymmetric(pt)

    def decode(self, ct) -> np.ndarray:
        plain = self.dec.decrypt(ct)
        if self.ckks:
            return np.asarray(self.enc.decode_float64_polynomial(plain))
        return np.asarray(self.enc.decode_polynomial(plain))

    def check(self, got, want):
        if self.ckks:
            np.testing.assert_allclose(got, want, rtol=0, atol=CKKS_ATOL)
        else:
            np.testing.assert_array_equal(np.asarray(got, np.uint64),
                                          np.asarray(want, np.uint64))


@pytest.fixture(scope="module", params=["BFV", "BGV", "CKKS"])
def W(request):
    return WideLwe(request.param)


@pytest.mark.parametrize("term", [0, 1, 7, N - 1])
def test_wide_extract_and_assemble(W, term):
    for ct in (W.ct, W.ev.transform_from_ntt(W.ct) if W.ct.is_ntt_form
               else W.ev.transform_to_ntt(W.ct)):
        lwe = W.ev.extract_lwe(ct, term)
        back = W.ev.assemble_lwe(lwe)
        assert not back.is_ntt_form
        W.check(W.decode(back)[:1], W.coeffs[term:term + 1])


def test_wide_field_trace(W):
    """Only coefficient 0 survives the trace, where the factor n undoes the
    division."""
    tr = W.ev.field_trace(W.ev.divide_by_poly_modulus_degree(W.ct), W.glk, logn_stop=0)
    got = W.decode(tr)
    W.check(got[:1], W.coeffs[:1])
    W.check(got[1:], np.zeros(N - 1, W.coeffs.dtype))


@pytest.mark.parametrize("m", [1, 3, 8, N])
def test_wide_pack_lwe_ciphertexts(W, m):
    terms = [(5 * i) % N for i in range(m)] if m < N else list(range(m))
    packed = W.ev.pack_lwe_ciphertexts([W.ev.extract_lwe(W.ct, i) for i in terms], W.glk)
    assert packed.is_ntt_form == (W.scheme != "BFV")
    stride = N >> (max(1, (m - 1).bit_length()) if m > 1 else 0)
    got = W.decode(packed)
    W.check(got[::stride][:m], W.coeffs[terms])
    if m == 1:
        W.check(got[1:], np.zeros(N - 1, W.coeffs.dtype))


def test_jax_wide_extract_lwe_fault():
    """Reference fault: the JAX package's extract_lwe reads qtab["q"], which
    its wide table pack lacks, so it raises KeyError on a wide ciphertext."""
    from troy_tpu.core.params import EncryptionParameters as JParams, SchemeType as JScheme
    from troy_tpu.core.coeff_modulus import (CoeffModulus as JCoeff, PlainModulus as JPlain,
                                             SecurityLevel as JSec)
    from troy_tpu.core.context import HeContext as JContext
    from troy_tpu.core.keygen import KeyGenerator as JKeyGen
    from troy_tpu.core.encryptor import Encryptor as JEncryptor
    from troy_tpu.core.evaluator import Evaluator as JEvaluator
    from troy_tpu.core.batch_encoder import BatchEncoder as JBatchEncoder

    jp = JParams(JScheme.BFV).set_poly_modulus_degree(N)
    jp.set_coeff_modulus(JCoeff.create(N, BITS)).set_plain_modulus(JPlain.batching(N, LOG_T))
    jc = JContext.create(jp, True, JSec.Nil, SEED)
    jkg = JKeyGen(jc)
    jct = JEncryptor(jc, sk=jkg.secret_key).encrypt_symmetric(
        JBatchEncoder(jc).encode_polynomial(np.arange(N, dtype=np.uint64)))
    with pytest.raises(KeyError, match="'q'"):
        JEvaluator(jc).extract_lwe(jct, 0)
