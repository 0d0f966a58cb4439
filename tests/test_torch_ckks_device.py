"""The port's device CKKS encoder (CKKSEncoder.encode_device /
decode_device: torch.fft in complex128 and exact integer passes) against the
JAX package's device encoder (its double-float path) and the host encoder,
to the tolerances of tests/core/test_ckks_device_encode.py:

  * decoded values within 1e-5 at scale 2^25 for |v| <= 1, and within
    max(64 / scale, mag 2^-38) 8 over the property sweep of random scales
    and magnitudes;
  * the residues equal the host encode's but at coefficients next to a .5
    rounding boundary, one unit apart: fewer than n/64 of them;
  * the multi-word tiers (W = 3, 4, 5 words of 24 bits) on 30-bit chains up
    to 5 x 30 bits: the centred coefficients within C 2^-45 + 2 of the host
    encode's (C = scale max|v|), and at scale 2^40 with |v| <= 1000 the
    decoded values within the sweep's bound;
  * decode_device within 2^-38 of the JAX decode_device and of the host
    decode, relative to the largest value, at a fresh and a rescaled level;
  * the gates' ValueErrors (2^117, q/2, 120-bit margin) with the JAX
    messages, and a leading batch axis through both."""

import math

import jax.numpy as jnp
import numpy as np
import pytest

from troy_tpu.core.params import EncryptionParameters as JParams, SchemeType as JScheme
from troy_tpu.core.coeff_modulus import CoeffModulus as JCoeff, SecurityLevel as JSec
from troy_tpu.core.context import HeContext as JContext
from troy_tpu.core.ckks_encoder import CKKSEncoder as JCKKSEncoder
from troy_tpu.core.plaintext import Plaintext as JPlaintext
from troy_tpu_torch.core.params import EncryptionParameters, SchemeType
from troy_tpu_torch.core.coeff_modulus import CoeffModulus, SecurityLevel
from troy_tpu_torch.core.context import HeContext
from troy_tpu_torch.core.ckks_encoder import CKKSEncoder
from troy_tpu_torch.core.keygen import KeyGenerator
from troy_tpu_torch.core.encryptor import Encryptor
from troy_tpu_torch.core.decryptor import Decryptor
from troy_tpu_torch.core.evaluator import Evaluator
from troy_tpu_torch.ops import ntt as NTT

REL = 2.0 ** -38


class Enc:
    """A CKKS chain in both packages and their encoders."""

    def __init__(self, n: int, bits):
        jp = JParams(JScheme.CKKS).set_poly_modulus_degree(n).set_coeff_modulus(
            JCoeff.create(n, bits))
        tp = EncryptionParameters(SchemeType.CKKS).set_poly_modulus_degree(n)
        tp.set_coeff_modulus(CoeffModulus.create(n, bits))
        self.n = n
        self.jc = JContext.create(jp, True, JSec.Nil, 3)
        self.tc = HeContext.create(tp, "cpu", SecurityLevel.Nil, seed=3)
        self.jenc, self.enc = JCKKSEncoder(self.jc), CKKSEncoder(self.tc)
        self.rng = np.random.default_rng(n + len(bits))

    def values(self, mag=1.0, lead=()):
        shape = (*lead, self.n // 2)
        return mag * (self.rng.uniform(-1, 1, shape) + 1j * self.rng.uniform(-1, 1, shape))

    def jax_plain(self, pt) -> JPlaintext:
        return JPlaintext(jnp.asarray(pt.data.numpy().astype(np.uint32)), pt.parms_id,
                          pt.scale, pt.is_ntt_form)

    def centred(self, pt) -> np.ndarray:
        cd = self.tc.get_context_data(pt.parms_id)
        arr = NTT.ntt_inverse(pt.data, cd.qtab()).numpy()
        Q = cd.base_q.prod
        comp = np.array(cd.base_q.compose_array_host(arr), dtype=object)
        return np.where(comp > Q // 2, comp - Q, comp)


def rel_err(a, b) -> float:
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


@pytest.fixture(scope="module")
def E3():
    return Enc(1024, [30, 30, 30])


def test_encode_device_against_host_and_jax(E3):
    v = E3.values()
    scale = 2.0 ** 25
    pd, ph = E3.enc.encode_device(v, scale=scale), E3.enc.encode(v, scale=scale)
    assert (pd.parms_id, pd.scale, pd.is_ntt_form) == (ph.parms_id, ph.scale, True)
    assert tuple(pd.data.shape) == tuple(ph.data.shape)
    diff = np.abs((E3.centred(pd) - E3.centred(ph)).astype(np.int64))
    assert diff.max() <= 1 and (diff != 0).sum() < E3.n // 64
    for got in (E3.enc.decode(pd), E3.jenc.decode(E3.jax_plain(pd))):
        assert np.max(np.abs(got - v)) < 1e-5
    jd = E3.jenc.encode_device(v, scale=scale)
    assert np.max(np.abs(E3.enc.decode(pd) - E3.jenc.decode(jd))) < 1e-5


def test_random_scales_and_magnitudes():
    """The JAX tests' property sweep at n = 64 on 3 x 30-bit primes."""
    e = Enc(64, [30, 30, 30])
    rng = np.random.default_rng(12)
    for _ in range(12):
        scale = float(2.0 ** rng.uniform(18, 30)) * rng.uniform(0.8, 1.2)
        mag = float(10 ** rng.uniform(-2, 3))
        if scale * mag >= 2.0 ** 45:
            continue
        v = e.values(mag)
        back = e.enc.decode(e.enc.encode_device(v, scale=scale))
        tol = max(64.0 / scale, mag * 2.0 ** -38) * 8
        assert np.max(np.abs(back - v)) < tol, (scale, mag)


@pytest.mark.parametrize("scale", [2.0 ** 50, 2.0 ** 72, 2.0 ** 95, 2.0 ** 110])
def test_multiword_tiers_against_host(scale):
    """W = 3, 4, 5 on 6 x 30-bit primes (5 x 30 at the first level, 4 x 30
    at the next): centred coefficients within C 2^-45 + 2 of the host's."""
    e = Enc(64, [30] * 6)
    ctx = e.tc
    v = e.values()
    C = scale * np.max(np.abs(v))
    checked = 0
    for pid in (ctx.first_parms_id, ctx.first_context_data().next.parms_id):
        cd = ctx.get_context_data(pid)
        if 4 * C >= 2.0 ** cd.total_coeff_modulus.bit_length():
            continue
        pd, ph = e.enc.encode_device(v, pid, scale=scale), e.enc.encode(v, pid, scale=scale)
        diff = np.abs(e.centred(pd) - e.centred(ph))
        assert int(diff.max()) <= int(C * 2.0 ** -45) + 2
        checked += 1
    assert checked >= 1


def test_five_limbs_at_scale_2_40_large_values():
    e = Enc(1024, [30] * 6)
    for mag in (1.0, 1000.0):
        v = e.values(mag)
        pd = e.enc.encode_device(v, scale=2.0 ** 40)
        back = e.enc.decode(pd)
        assert np.max(np.abs(back - v)) < max(64.0 / 2.0 ** 40, mag * 2.0 ** -38) * 8
        assert rel_err(e.enc.decode_device(pd), back) < REL


def test_gates():
    e = Enc(64, [30, 30, 30])
    with pytest.raises(ValueError, match="exceeds the 2\\^117 device bound"):
        e.enc.encode_device(np.full(4, 2.0 ** 80), scale=2.0 ** 40)
    with pytest.raises(ValueError, match="scaled values exceed q/2"):
        e.enc.encode_device(np.full(4, 2.0 ** 50), scale=2.0 ** 40)
    with pytest.raises(ValueError, match="too many values"):
        e.enc.encode_device(np.zeros(33))
    wide = Enc(64, [30] * 6)
    pt = wide.enc.encode(wide.values(), scale=2.0 ** 20)  # margin 150 - 20 = 130
    with pytest.raises(ValueError, match="120-bit device envelope"):
        wide.enc.decode_device(pt)
    with pytest.raises(ValueError, match="120-bit device envelope"):
        wide.jenc.decode_device(wide.jax_plain(pt))


def test_batch_axis(E3):
    vs = E3.values(lead=(3,))
    pt = E3.enc.encode_device(vs, scale=2.0 ** 25)
    assert tuple(pt.data.shape) == (3, 2, 1024)
    for i in range(3):
        row = E3.enc.encode_device(vs[i], scale=2.0 ** 25)
        assert bool((pt.data[i] == row.data).all())
    got = E3.enc.decode_device(pt)
    assert got.shape == vs.shape and np.max(np.abs(got - vs)) < 1e-5


def test_decode_device_fresh_level(E3):
    v = E3.values()
    pt = E3.enc.encode(v, scale=2.0 ** 25)
    got = E3.enc.decode_device(pt)
    assert rel_err(got, E3.enc.decode(pt)) < REL
    assert rel_err(got, E3.jenc.decode_device(E3.jax_plain(pt))) < REL
    assert np.max(np.abs(got - v)) < 1e-5


def test_decode_device_rescaled_level():
    """The serving case: multiply + relinearize + rescale, then decode
    (scale 2^26 on 4 x 30-bit primes, data level 3 -> 2)."""
    e = Enc(1024, [30, 30, 30, 30])
    kg = KeyGenerator(e.tc)
    encr = Encryptor(e.tc, sk=kg.secret_key)
    ev, dec = Evaluator(e.tc), Decryptor(e.tc, kg.secret_key)
    a, b = e.values(), e.values()
    ca = encr.encrypt_symmetric(e.enc.encode(a, scale=2.0 ** 26))
    cb = encr.encrypt_symmetric(e.enc.encode(b, scale=2.0 ** 26))
    ct = ev.rescale_to_next(ev.relinearize(ev.multiply(ca, cb), kg.create_relin_keys()))
    pt = dec.decrypt(ct)
    assert pt.parms_id == e.tc.first_context_data().next.parms_id
    got = e.enc.decode_device(pt)
    assert rel_err(got, e.enc.decode(pt)) < REL
    assert rel_err(got, e.jenc.decode_device(e.jax_plain(pt))) < REL
    assert np.max(np.abs(got - a * b)) < 1e-3


def test_decode_device_coefficient_form(E3):
    """A plaintext in coefficient form skips the inverse NTT."""
    v = E3.values()
    pt = E3.enc.encode(v, scale=2.0 ** 25)
    cd = E3.tc.get_context_data(pt.parms_id)
    coeff = type(pt)(NTT.ntt_inverse(pt.data, cd.qtab()), pt.parms_id, False, pt.scale)
    assert rel_err(E3.enc.decode_device(coeff), E3.enc.decode(pt)) < REL


def test_decode_device_margins_near_the_envelope():
    """margin 110 on 5 x 30-bit primes, scale 2^40: the exact fixed-point
    CRT keeps relative precision to the gate (no float cancellation)."""
    e = Enc(64, [30] * 6)
    v = e.values()
    pt = e.enc.encode(v, scale=2.0 ** 40)
    cd = e.tc.get_context_data(pt.parms_id)
    assert cd.total_coeff_modulus.bit_length() - math.log2(pt.scale) == 110
    assert rel_err(e.enc.decode_device(pt), e.enc.decode(pt)) < REL
    assert rel_err(e.enc.decode_device(pt), v) < 1e-9


def test_jax_decode_device_cancellation_fault():
    """The reference fault the port does not copy: the JAX decode_device
    converts a negative fraction's two's-complement words by adding a
    negative top word to positive lower words in double-float32, which
    cancel and leave about 2^-92 of absolute error in value / Q, so its
    error grows as (Q / scale) 2^-92 and passes 1 at margin 92.  At n = 64 on
    5 x 30-bit primes (data level Q = 120 bits), scale 2^20 (margin 100):
    the port negates in integers first and stays at float64 precision."""
    e = Enc(64, [30] * 5)
    v = e.values()
    pt = e.enc.encode(v, scale=2.0 ** 20)
    assert np.max(np.abs(e.jenc.decode_device(e.jax_plain(pt)) - v)) > 1.0
    assert rel_err(e.enc.decode_device(pt), e.enc.decode(pt)) < REL
    assert np.max(np.abs(e.enc.decode_device(pt) - v)) < 1e-5
