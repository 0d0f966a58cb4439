"""tests/test_torch_wide.py's wide-path parity tests for CKKS (its own file,
so that pytest-xdist's loadfile gives it its own worker), with the wide
cases of the device CKKS encoder (tests/core/test_ckks_device_encode.py:126,
:266) and the examples/16_wide_params.py flow.  The size-4 relinearization
and the noise budget are BFV and BGV tests (tests/core/test_wide_e2e.py)."""

import numpy as np
import pytest

import jax.numpy as jnp
from troy_tpu.ops import ddfft as DD

from .test_torch_wide import *  # noqa: F401,F403
from .test_torch_wide import WidePair, SCALE, same_ct, same_w

del test_size4_relinearize, test_noise_budget  # noqa: F821


@pytest.fixture(scope="module", params=["CKKS"])
def W(request):
    return WidePair(request.param)


def _ckks_pair(n, bits, scale):
    """A CKKS encoder of each package on bits at degree n."""
    from troy_tpu.core.params import EncryptionParameters as JParams, SchemeType as JScheme
    from troy_tpu.core.coeff_modulus import CoeffModulus as JCoeff, SecurityLevel as JSec
    from troy_tpu.core.context import HeContext as JContext
    from troy_tpu.core.ckks_encoder import CKKSEncoder as JCKKSEncoder
    from troy_tpu_torch.core.params import EncryptionParameters, SchemeType
    from troy_tpu_torch.core.coeff_modulus import CoeffModulus, SecurityLevel
    from troy_tpu_torch.core.context import HeContext
    from troy_tpu_torch.core.ckks_encoder import CKKSEncoder

    jp = JParams(JScheme.CKKS).set_poly_modulus_degree(n)
    jp.set_coeff_modulus(JCoeff.create(n, list(bits)))
    tp = EncryptionParameters(SchemeType.CKKS).set_poly_modulus_degree(n)
    tp.set_coeff_modulus(CoeffModulus.create(n, list(bits)))
    jc = JContext.create(jp, True, JSec.Nil, 1)
    tc = HeContext.create(tp, True, SecurityLevel.Nil, seed=1, device="cpu")
    return jc, tc, JCKKSEncoder(jc), CKKSEncoder(tc)


def test_device_encoder_roundtrip_and_host_parity():
    """tests/core/test_ckks_device_encode.py's wide case of
    test_roundtrip_and_host_parity, (60, 40, 40) at n = 64 and scale 2^25:
    encode_device decodes within 1e-5 of the values and of the host
    encoding; decode_device within 1e-8 of the host decode; the JAX
    package's device encoding decodes to the same values within 1e-5."""
    jc, tc, jenc, enc = _ckks_pair(64, (60, 40, 40), 2.0 ** 25)
    rng = np.random.default_rng(5)
    v = rng.uniform(-1, 1, enc.slot_count) + 1j * rng.uniform(-1, 1, enc.slot_count)
    pt_dev, pt_host = enc.encode_device(v, scale=2.0 ** 25), enc.encode(v, scale=2.0 ** 25)
    d_dev, d_host = enc.decode(pt_dev), enc.decode(pt_host)
    assert np.max(np.abs(d_dev - v)) < 1e-5 and np.max(np.abs(d_dev - d_host)) < 1e-5
    assert tuple(pt_dev.data.shape) == tuple(pt_host.data.shape)
    assert np.max(np.abs(enc.decode_device(pt_host) - d_host)) < 1e-8
    jd = jenc.decode(jenc.encode_device(v, scale=2.0 ** 25))
    assert np.max(np.abs(jd - d_dev)) < 1e-5


def test_device_decoder_wide_path():
    """The JAX test_wide_path: (50, 40) at scale 2^35, a host encoding at
    the last level decodes on the device within 1e-6 of the host decode."""
    jc, tc, jenc, enc = _ckks_pair(64, (50, 40), 2.0 ** 35)
    v = np.random.default_rng(12).uniform(-1, 1, enc.slot_count)
    pt = enc.encode(v, parms_id=tc.last_parms_id, scale=2.0 ** 35)
    assert np.max(np.abs(enc.decode_device(pt) - enc.decode(pt))) < 1e-6
    same_w(jenc.encode(v, parms_id=jc.last_parms_id, scale=2.0 ** 35).data, pt.data)


def test_device_encoder_after_rescale(W):
    """A wide product, relinearized and rescaled, decodes on the device
    within 1e-5 of the values; a large-scale encode_device (values at 2^54,
    the mantissa-and-exponent rounding) decodes back within the host's."""
    m = W.message()
    j1, c1 = W.pair(m)
    r = W.ev.rescale_to_next(W.ev.relinearize(W.ev.multiply(c1, c1), W.rlk))
    np.testing.assert_allclose(W.cod.decode_device(W.dec.decrypt(r)), m * m, rtol=0, atol=1e-5)
    big = W.cod.encode_device(m * 2.0 ** 14, scale=SCALE)
    np.testing.assert_allclose(W.cod.decode_device(big), m * 2.0 ** 14, rtol=0, atol=1e-6)


def test_rns_reduction_exact_wide():
    """The JAX test at :126: exact integers below 2^100 reduced into wide
    residues, against Python ints (the port's _round_to_rns above 2^52)."""
    p = WidePair("CKKS")
    cd = p.tc.first_context_data()
    rng = np.random.default_rng(126)
    x = rng.uniform(-1, 1, 64) * 2.0 ** rng.integers(0, 100, 64)
    import torch
    got = p.cod._round_to_rns(torch.from_numpy(x), cd, big=True)
    for i, q in enumerate(cd.base_q.values):
        assert [int(v) for v in got[i].tolist()] == [int(round(v)) % q for v in x]


def test_example_16_wide_params():
    """examples/16_wide_params.py on the port at n = 128: x^2 after
    multiply, relinearize and rescale at scale 2^40 within 1e-6, and
    rotate_vector(5) within 1e-6, equal to the JAX package's ciphertexts.
    The example makes the default Galois key set; here the keys of steps 1
    and 4, the two rounds rotate_vector(5) takes, to keep the JAX side's
    key generation short."""
    p = WidePair("CKKS", n=128, seed=0x16)
    v = np.linspace(0, 1, p.cod.slot_count)
    jct = p.jencr.encrypt_asymmetric(p.jcod.encode(v, scale=SCALE))
    ct = p.encr.encrypt_asymmetric(p.cod.encode(v, scale=SCALE))
    same_ct(jct, ct)
    prod = p.ev.rescale_to_next(p.ev.relinearize(p.ev.multiply(ct, ct), p.rlk))
    jprod = p.jev.rescale_to_next(p.jev.relinearize(p.jev.multiply(jct, jct), p.jrlk))
    same_ct(jprod, prod)
    assert np.abs(p.cod.decode(p.dec.decrypt(prod)).real - v * v).max() < 1e-6
    jglk = p.jkg.create_galois_keys_from_steps([1, 4])
    glk = p.kg.create_galois_keys_from_steps([1, 4])
    rot = p.ev.rotate_vector(ct, 5, glk)
    same_ct(p.jev.rotate_vector(jct, 5, jglk), rot)
    assert np.abs(p.cod.decode(p.dec.decrypt(rot)).real - np.roll(v, -5)).max() < 1e-6
