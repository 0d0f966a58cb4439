"""BFV rotations of the port against the JAX package, bit for bit, on
ciphertexts and Galois keys made by the JAX package and carried over with
troy_tpu_torch.interop: apply_galois in both forms, rotate_rows through the
step's own key and through the NAF fallback, rotate_columns, and the batched
steps against the jitted JAX steps.  Every result decrypts to the rotated
slots, and Galois keys made by the port rotate right in both packages."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from troy_tpu.core.keys import GaloisKeys as JGaloisKeys
from troy_tpu.ops.galois import GaloisTool as JGalois
from troy_tpu.parallel.batched import BatchedEvaluator as JBatched
from troy_tpu_torch import interop
from troy_tpu_torch.core.keygen import KeyGenerator
from troy_tpu_torch.parallel.batched import BatchedEvaluator

from .test_torch_client import Both, N, same_ct

KEY_STEPS = [1, -1, 4]
ELEMENTS = [JGalois.get_element_from_step(s, N) for s in KEY_STEPS] + [2 * N - 1]
BATCH = 2


def rotated(m: np.ndarray, steps: int | None) -> np.ndarray:
    """Slots after rotate_rows(steps) (each row of n/2 slots cyclically
    rotated left), or after rotate_columns (steps=None: the rows swapped)."""
    rows = m.astype(np.int64).reshape(2, N // 2)
    rows = rows[::-1] if steps is None else np.roll(rows, -steps, axis=1)
    return rows.reshape(N)


@pytest.fixture(scope="module")
def flow():
    both = Both()
    rng = np.random.default_rng(17)
    msgs = both.messages(BATCH, rng)
    jcts = both.jax_cts(msgs)
    jglk = both.jkg.create_galois_keys_from_elements(ELEMENTS)
    glk = interop.galois_keys({g: np.asarray(k) for g, k in jglk.keys.items()},
                              both.tc.key_parms_id, "cpu")
    return dict(both=both, msgs=msgs, jcts=jcts, jglk=jglk, glk=glk)


@pytest.mark.parametrize("ntt_form", [False, True])
@pytest.mark.parametrize("elt", [ELEMENTS[0], 2 * N - 1])
def test_apply_galois(flow, elt, ntt_form):
    both, jct = flow["both"], flow["jcts"][0]
    ct = both.port(jct)
    if ntt_form:
        jct, ct = both.jev.transform_to_ntt(jct), both.ev.transform_to_ntt(ct)
    jout = both.jev.apply_galois(jct, elt, flow["jglk"])
    out = both.ev.apply_galois(ct, elt, flow["glk"])
    same_ct(jout, out)
    if ntt_form:
        out = both.ev.transform_from_ntt(out)
    want = rotated(flow["msgs"][0], None if elt == 2 * N - 1 else 1)
    np.testing.assert_array_equal(both.decode(out), want)


@pytest.mark.parametrize("steps", [1, -1, 4, 3, 5, 0])
def test_rotate_rows(flow, steps):
    """Steps 1, -1, 4 have their own keys; 3 = -1 + 4 and 5 = 1 + 4 take the
    NAF fallback; 0 is the identity."""
    both, jct = flow["both"], flow["jcts"][1]
    out = both.ev.rotate_rows(both.port(jct), steps, flow["glk"])
    same_ct(both.jev.rotate_rows(jct, steps, flow["jglk"]), out)
    np.testing.assert_array_equal(both.decode(out), rotated(flow["msgs"][1], steps))


@pytest.mark.parametrize("steps", [-4, 8, 7])
def test_rotate_rows_without_a_key_raises(flow, steps):
    """A step whose NAF reaches a power of two without a key: the port raises
    KeyError, where the JAX package recurses until RecursionError."""
    both, jct = flow["both"], flow["jcts"][1]
    with pytest.raises(KeyError, match="no Galois key"):
        both.ev.rotate_rows(both.port(jct), steps, flow["glk"])
    with pytest.raises(RecursionError):
        both.jev.rotate_rows(jct, steps, flow["jglk"])


def test_rotate_columns(flow):
    both, jct = flow["both"], flow["jcts"][0]
    out = both.ev.rotate_columns(both.port(jct), flow["glk"])
    same_ct(both.jev.rotate_columns(jct, flow["jglk"]), out)
    np.testing.assert_array_equal(both.decode(out), rotated(flow["msgs"][0], None))


@pytest.mark.parametrize("steps", [1, 3, -1, None])
def test_batched_step_matches_jax(flow, steps):
    """build_rotate_rows_step(steps) (None: build_rotate_columns_step), the
    port's step against the jitted JAX step on the stacked batch; row 0 also
    against the object API."""
    both = flow["both"]
    jcd, tcd = both.jc.first_context_data(), both.tc.first_context_data()
    jb, tb = JBatched(both.jev, jcd), BatchedEvaluator(both.ev, tcd)
    if steps is None:
        (jstep, jelts), (step, elts) = jb.build_rotate_columns_step(), tb.build_rotate_columns_step()
    else:
        (jstep, jelts), (step, elts) = (jb.build_rotate_rows_step(steps),
                                        tb.build_rotate_rows_step(steps))
    assert elts == jelts
    d = np.stack([np.asarray(c.data) for c in flow["jcts"]])
    want = np.asarray(jax.jit(jstep)(jnp.asarray(d), tuple(flow["jglk"].key(e) for e in jelts)))
    got = step(interop.to_tensor(d, "cpu"), tuple(flow["glk"].key(e) for e in elts))
    np.testing.assert_array_equal(interop.to_numpy(got), want)
    for b in range(BATCH):
        ct = interop.ciphertext(want[b], tcd.parms_id, "cpu")
        np.testing.assert_array_equal(both.decode(ct), rotated(flow["msgs"][b], steps))
    obj = (both.ev.rotate_columns(both.port(flow["jcts"][0]), flow["glk"]) if steps is None
           else both.ev.rotate_rows(both.port(flow["jcts"][0]), steps, flow["glk"]))
    assert torch.equal(got[0], obj.data)


def test_galois_elements_for_steps(flow):
    tcd = flow["both"].tc.first_context_data()
    tb = BatchedEvaluator(flow["both"].ev, tcd)
    jb = JBatched(flow["both"].jev, flow["both"].jc.first_context_data())
    for steps in (1, 2, 3, -1, -3, 6, 7, 64):
        assert tb.galois_elements_for_steps(steps) == jb.galois_elements_for_steps(steps)
    with pytest.raises(ValueError):
        tb.galois_elements_for_steps(0)


@pytest.mark.parametrize("how", ["steps", "default"])
def test_port_galois_keys_rotate_in_both_packages(flow, how):
    """Galois keys made by the port (over the JAX secret key): the port's
    rotation decrypts right in both packages, and the JAX evaluator with
    the port's keys gives the port's result bit for bit."""
    both, jct = flow["both"], flow["jcts"][0]
    kg = KeyGenerator(both.tc, torch.Generator().manual_seed(21), sk=both.sk)
    glk = kg.create_galois_keys_from_steps([3]) if how == "steps" else kg.create_galois_keys()
    powers = [1 << i for i in range(N.bit_length() - 2)]    # 1, 2, ..., n/4
    want_elts = ({JGalois.get_element_from_step(3, N)} if how == "steps" else
                 {JGalois.get_element_from_step(s, N) for p in powers for s in (p, -p)}
                 | {2 * N - 1})
    assert set(glk.keys) == want_elts and all(
        tuple(k.shape) == (3, 2, 4, N) for k in glk.keys.values())
    out = both.ev.rotate_rows(both.port(jct), 3, glk)
    want = rotated(flow["msgs"][0], 3)
    np.testing.assert_array_equal(both.decode(out), want)
    np.testing.assert_array_equal(both.jax_decode(out), want)
    jglk = JGaloisKeys({g: jnp.asarray(interop.to_numpy(k)) for g, k in glk.keys.items()},
                       glk.parms_id)
    same_ct(both.jev.rotate_rows(jct, 3, jglk), out)
