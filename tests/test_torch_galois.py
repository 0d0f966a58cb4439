"""Galois automorphisms of the port against the JAX package, bit for bit:
the NAF decomposition, the step -> element map, the coefficient and NTT
permutation tables, and their application to residues, for rotation steps
+-1, +-3, 5 and the conjugation element."""

import numpy as np
import jax.numpy as jnp
import pytest

from troy_tpu.ops.galois import GaloisTool as JGalois
from troy_tpu.utils.numth import naf as jnaf
from troy_tpu_torch import interop
from troy_tpu_torch.ops.galois import GaloisTool
from troy_tpu_torch.utils.numth import naf

from .test_torch_client import Both, N, same

STEPS = [1, -1, 3, -3, 5]
ELEMENTS = [JGalois.get_element_from_step(s, N) for s in STEPS] + [2 * N - 1]


@pytest.fixture(scope="module")
def both():
    return Both()


@pytest.mark.parametrize("value", [3, -1, 1, 4, 7, -5, 12, 511, -512, 4095])
def test_naf(value):
    digits = naf(value)
    assert digits == jnaf(value)
    assert sum(digits) == value
    assert all(d & (d - 1) == 0 for d in map(abs, digits))


def test_naf_of_three():
    assert naf(3) == [-1, 4]


@pytest.mark.parametrize("step", STEPS + [0, 100, -100])
def test_element_from_step(step):
    assert GaloisTool.get_element_from_step(step, N) == JGalois.get_element_from_step(step, N)
    assert GaloisTool.conjugate_element(N) == JGalois.conjugate_element(N) == 2 * N - 1


@pytest.mark.parametrize("elt", ELEMENTS)
def test_tables(both, elt):
    tool = GaloisTool.for_context(both.tc.first_context_data())
    jtool = JGalois.for_context(both.jc.first_context_data())
    perm, neg = tool.coeff_table(elt)
    jperm, jneg = jtool._build_coeff(elt)
    np.testing.assert_array_equal(perm.numpy(), np.asarray(jperm))
    np.testing.assert_array_equal(neg.numpy(), np.asarray(jneg))
    np.testing.assert_array_equal(tool.ntt_table(elt).numpy(), np.asarray(jtool._build_ntt(elt)))
    assert sorted(tool.ntt_table(elt).tolist()) == list(range(N))


@pytest.mark.parametrize("domain", ["coeff", "ntt"])
@pytest.mark.parametrize("elt", ELEMENTS)
def test_apply(both, elt, domain):
    """(2, 2, L, n) residues through apply_coeff / apply_ntt."""
    jcd, tcd = both.jc.first_context_data(), both.tc.first_context_data()
    x = both.residues(jcd, (2, 2))
    jtool = JGalois.for_context(jcd)
    tool = GaloisTool.for_context(tcd)
    tx = interop.to_tensor(x, "cpu")
    if domain == "coeff":
        same(jtool.apply_coeff(jnp.asarray(x), elt, jcd.qtab()),
             tool.apply_coeff(tx, elt, tcd.qtab()))
    else:
        same(jtool.apply_ntt(jnp.asarray(x), elt), tool.apply_ntt(tx, elt))
