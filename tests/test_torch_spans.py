"""The port's spans (utils/timer.py `span`): with no profiler recording a
span enters no record_function and makes no CUDA event; under
torch.profiler each batched step's trace holds every span of its layers,
nested as the calls nest; and the outputs are the same bit for bit with the
profiler on and off.  The launch counters read and reset as one registry."""

import pytest
import torch

from troy_tpu_torch.core.coeff_modulus import CoeffModulus, PlainModulus, SecurityLevel
from troy_tpu_torch.core.context import HeContext
from troy_tpu_torch.core.evaluator import Evaluator
from troy_tpu_torch.core.keygen import KeyGenerator
from troy_tpu_torch.core.params import EncryptionParameters, SchemeType
from troy_tpu_torch.ops import bconv_cuda, fused_mul_cuda, ntt_cuda, ntt_mxu_cuda
from troy_tpu_torch.parallel.batched import BatchedEvaluator
from troy_tpu_torch.utils.timer import SPAN_PREFIX, launch_counts, reset_launch_counts, span

N, BATCH = 1024, 2


def _residues(gen, cd, shape):
    q = cd.qtab().q.view(-1, 1)
    return torch.randint(0, 1 << 62, (*shape, cd.coeff_modulus_size, N), generator=gen) % q


def _batched(scheme, bits, seed):
    p = EncryptionParameters(scheme).set_poly_modulus_degree(N)
    p.set_coeff_modulus(CoeffModulus.create(N, bits))
    if scheme == SchemeType.BFV:
        p.set_plain_modulus(PlainModulus.batching(N, 20))
    ctx = HeContext.create(p, True, SecurityLevel.Nil, seed=seed, device="cpu")
    cd = ctx.first_context_data()
    return KeyGenerator(ctx), cd, BatchedEvaluator(Evaluator(ctx), cd)


@pytest.fixture(scope="module")
def steps():
    """name -> (step, inputs): a BFV multiply + relinearize, a BFV
    rotate_rows(1) and a CKKS multiply + relinearize + rescale on the wide
    {60, 40, 40, 60} chain, each on a batch of random residues."""
    gen = torch.Generator().manual_seed(21)
    kg, cd, be = _batched(SchemeType.BFV, [30, 30, 30, 30], 3)
    rlk = kg.create_relin_keys().key(2)
    mr = be.build_mul_relin_step(rlk)
    rot, elts = be.build_rotate_rows_step(1)
    glk = kg.create_galois_keys_from_elements(elts)
    ks = tuple(glk.key(e) for e in elts)
    out = {"bfv_mul_relin": (lambda a, b: mr(a, b, rlk),
                             (_residues(gen, cd, (BATCH, 2)), _residues(gen, cd, (BATCH, 2)))),
           "bfv_rotate_rows": (lambda a: rot(a, ks), (_residues(gen, cd, (BATCH, 2)),))}
    kg, cd, be = _batched(SchemeType.CKKS, [60, 40, 40, 60], 4)
    ckks_rlk = kg.create_relin_keys().key(2)
    ckks_mr, rs = be.build_mul_relin_step(ckks_rlk), be.build_rescale_step()
    out["ckks_mul_relin_rescale"] = (
        lambda a, b: rs(ckks_mr(a, b, ckks_rlk)),
        (_residues(gen, cd, (BATCH, 2)), _residues(gen, cd, (BATCH, 2))))
    return out


# the spans each step must show; (inner, outers): each inner range lies
# inside one of the outers'; (outer, inner): each outer range holds an inner
MUL = [("lift", ("multiply",)), ("floor", ("multiply",)), ("sk", ("multiply",)),
       ("bconv", ("floor", "sk"))]
KS = [("ks_digits", ("keyswitch",)), ("ks_inner", ("keyswitch",))]
EXPECTED = {
    "bfv_mul_relin": ({"multiply", "lift", "floor", "sk", "bconv", "keyswitch", "ks_digits",
                       "ks_inner", "ntt"}, MUL + KS, [("floor", "bconv"), ("sk", "bconv")]),
    "bfv_rotate_rows": ({"keyswitch", "ks_digits", "ks_inner", "ntt"}, KS,
                        [("keyswitch", "ntt")]),
    "ckks_mul_relin_rescale": ({"multiply", "keyswitch", "ks_digits", "ks_inner", "ntt",
                                "rescale"}, KS, [("rescale", "ntt"), ("keyswitch", "ntt")]),
}


def _ranges(prof) -> dict:
    """Span name -> [(start, end)] of the port's ranges in a profile."""
    out = {}
    for e in prof.events():
        if e.name.startswith(SPAN_PREFIX):
            out.setdefault(e.name[len(SPAN_PREFIX):], []).append(
                (e.time_range.start, e.time_range.end))
    return out


@pytest.mark.parametrize("name", list(EXPECTED))
def test_spans_off_on_and_bit_identical(steps, name, monkeypatch):
    step, inputs = steps[name]
    entered = []
    real_rf, real_event = torch.profiler.record_function, torch.cuda.Event

    def counting_rf(*a, **k):
        entered.append(a)
        return real_rf(*a, **k)

    def counting_event(*a, **k):
        entered.append(("event",))
        return real_event(*a, **k)

    with monkeypatch.context() as m:
        m.setattr(torch.profiler, "record_function", counting_rf)
        m.setattr(torch.cuda, "Event", counting_event)
        off = step(*inputs)
    assert entered == []

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        on = step(*inputs)
    assert torch.equal(on, off)

    want, inside, holds = EXPECTED[name]
    got = _ranges(prof)
    assert set(got) == want

    def within(r, outer):
        return r[0] >= outer[0] and r[1] <= outer[1]

    for inner, outers in inside:
        for r in got[inner]:
            assert any(within(r, o) for name in outers for o in got[name]), (inner, outers)
    for outer, inner in holds:
        for o in got[outer]:
            assert any(within(r, o) for r in got[inner]), (outer, inner)


def test_span_as_a_block():
    """The block form records its range under a profiler, nests around a
    decorated span, and is one flag check without one."""
    inner = span("inner")(lambda x: x + 1)
    block = span("block")
    with block:
        assert inner(1) == 2
    assert block._open == []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with block:
            inner(1)
    got = _ranges(prof)
    (ba, bb), (ia, ib) = got["block"][0], got["inner"][0]
    assert ba <= ia and ib <= bb
    assert inner.__name__ == "<lambda>" and inner.__wrapped__(1) == 2


def test_launch_counts_are_one_registry():
    """launch_counts reads the four kernel modules' LAUNCHES in one dict,
    and reset_launch_counts zeroes each of them where tests read it."""
    tables = (ntt_cuda.LAUNCHES, ntt_mxu_cuda.LAUNCHES, bconv_cuda.LAUNCHES,
              fused_mul_cuda.LAUNCHES)
    assert sum(len(t) for t in tables) == len(launch_counts())
    for t in tables:
        t[next(iter(t))] += 3
    counts = launch_counts()
    assert all(counts[next(iter(t))] >= 3 for t in tables)
    reset_launch_counts()
    assert set(launch_counts().values()) == {0}
    assert all(set(t.values()) == {0} for t in tables)
