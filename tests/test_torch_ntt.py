"""Port NTT (troy_tpu_torch/ops/ntt.py) against every NTT of the JAX
package: radix-2, six-step, and both Pallas kernels (K1 ntt_forward_pallas,
K2 ntt_forward_pallas_mxu) in interpret mode.  Bit for bit, including lazy
inputs in [0, 2q).

The CUDA kernel (csrc/ntt.cu) cannot run here; emulate_kernel replays its
schedule in PyTorch (the phase plan, the exchange index map of every phase,
the twiddle table NTTTables.kernel_phases and the u32
Shoup arithmetic with its range invariants), and is held to the plain
transform and the JAX package."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import troy_tpu.ops.ntt as JNTT
from troy_tpu.ops.ntt_mxu import MxuNTTTables
from troy_tpu.ops.ntt_pallas import (ntt_forward_pallas, ntt_inverse_pallas,
                                     ntt_forward_pallas_mxu,
                                     ntt_inverse_pallas_mxu)
from troy_tpu.core.modulus import Modulus as JModulus
from troy_tpu.utils import numth
from troy_tpu_torch.core.modulus import Modulus
from troy_tpu_torch.ops import ntt as TNTT, ntt_cuda
from troy_tpu_torch.ops.ntt import (CONSTANT_SLOTS, FACTOR_LEVEL, kernel_phase_plan,
                                   kernel_plan_code, phase_entries, phase_nodes,
                                   phase_slots)

RNG = np.random.default_rng(2024)


def jax_packs(log_n, primes, pallas):
    """{name: pack} for the JAX backends, built explicitly (the library's
    default pack depends on TROY_NTT_BACKEND)."""
    mods = [JModulus(p) for p in primes]
    tabs = JNTT.NTTTables(log_n, mods)
    radix2 = {k: jnp.asarray(v) for k, v in tabs.host.items()}
    sixstep = dict(radix2, **tabs._sixstep_pack())
    packs = {"radix2": radix2, "sixstep": sixstep}
    if pallas:
        packs["pallas"] = sixstep
        packs["pallas_mxu"] = dict(sixstep, **MxuNTTTables(log_n, mods).pack_prefixed())
    return packs


FORWARD = {"radix2": JNTT.ntt_forward, "sixstep": JNTT.ntt_forward,
           "pallas": ntt_forward_pallas, "pallas_mxu": ntt_forward_pallas_mxu}
INVERSE = {"radix2": JNTT.ntt_inverse, "sixstep": JNTT.ntt_inverse,
           "pallas": ntt_inverse_pallas, "pallas_mxu": ntt_inverse_pallas_mxu}


def residues(shape, primes, factor=1):
    q = np.array(primes, dtype=np.uint64)[:, None]
    return (RNG.integers(0, 1 << 62, size=shape, dtype=np.uint64) % (factor * q)
            ).astype(np.uint32)


def check(log_n, L, lead, pallas):
    n = 1 << log_n
    primes = numth.get_primes(2 * n, 30, L)
    tt = TNTT.NTTTables(log_n, [Modulus(p) for p in primes], "cpu")
    packs = jax_packs(log_n, primes, pallas)
    lazy = residues((*lead, L, n), primes, factor=2)   # forward takes [0, 2q)
    canon = residues((*lead, L, n), primes)
    fwd = TNTT.ntt_forward(torch.from_numpy(lazy.astype(np.int64)), tt).numpy()
    inv = TNTT.ntt_inverse(torch.from_numpy(canon.astype(np.int64)), tt).numpy()
    for name, pack in packs.items():
        np.testing.assert_array_equal(
            np.asarray(FORWARD[name](jnp.asarray(lazy), pack)), fwd, err_msg=name)
        np.testing.assert_array_equal(
            np.asarray(INVERSE[name](jnp.asarray(canon), pack)), inv, err_msg=name)
    back = TNTT.ntt_inverse(torch.from_numpy(fwd), tt).numpy()
    np.testing.assert_array_equal(back, lazy % np.array(primes, np.uint32)[:, None])


def test_ntt_matches_every_jax_backend():
    check(9, 2, (2,), pallas=True)


@pytest.mark.parametrize("log_n,L,lead", [(10, 3, (2, 2)), (11, 1, (1,))])
def test_ntt_matches_xla_backends(log_n, L, lead):
    check(log_n, L, lead, pallas=False)


def test_ntt_flagship_size():
    """n = 8192 over 7 primes against the radix-2 and six-step transforms."""
    check(13, 7, (1,), pallas=False)


def test_ntt_small_degree_radix2():
    """n < 256, where the JAX package has only the radix-2 transform."""
    check(4, 3, (3,), pallas=False)


def test_ntt_order_is_brv_odd_powers():
    """Position p of the forward NTT holds the evaluation at psi^(2 brv(p)+1)."""
    log_n, q = 5, numth.get_prime(64, 30)
    n = 1 << log_n
    tt = TNTT.NTTTables(log_n, [Modulus(q)], "cpu")
    psi = numth.try_minimal_primitive_root(2 * n, q)
    coeffs = RNG.integers(0, q, size=n)
    got = TNTT.ntt_forward(torch.tensor(coeffs)[None], tt)[0].tolist()
    for p in range(n):
        x = pow(psi, 2 * numth.reverse_bits(p, log_n) + 1, q)
        assert got[p] == sum(int(c) * pow(x, i, q) for i, c in enumerate(coeffs)) % q


def test_take_selects_limb_rows():
    primes = numth.get_primes(2 * 64, 30, 3)
    tt = TNTT.NTTTables(6, [Modulus(p) for p in primes], "cpu")
    sub = tt.take([2, 0])
    assert [m.value for m in sub.moduli] == [primes[2], primes[0]]
    x = torch.from_numpy(residues((2, 64), [primes[2], primes[0]]).astype(np.int64))
    ref = TNTT.NTTTables(6, [Modulus(primes[2]), Modulus(primes[0])], "cpu")
    assert torch.equal(TNTT.ntt_forward(x, sub), TNTT.ntt_forward(x, ref))
    assert torch.equal(sub.kernel_rows, ref.kernel_rows)
    assert torch.equal(sub.kernel_scalars, ref.kernel_scalars)
    assert torch.equal(sub.kernel_phases, ref.kernel_phases)
    assert (sub.phase_plan, sub.plan_code) == (ref.phase_plan, ref.plan_code)


def test_kernel_wrapper_refuses_cpu_tensors():
    """The CUDA wrapper launches or raises; it never computes on the CPU."""
    tt = TNTT.NTTTables(4, [Modulus(numth.get_prime(32, 30))], "cpu")
    x = torch.zeros(1, 16, dtype=torch.int64)
    for fn in (ntt_cuda.ntt_forward, ntt_cuda.ntt_inverse):
        with pytest.raises(ValueError):
            fn(x, tt)
    assert set(ntt_cuda.LAUNCHES.values()) == {0}


# ---------------------------------------------------------------------------
# The register-radix kernel's schedule, emulated.
# ---------------------------------------------------------------------------

U32 = 0xFFFFFFFF


def umulhi(x, y):
    """High 32 bits of x * y for u32 values held in int64."""
    return (x * (y >> 16) + ((x * (y & 0xFFFF)) >> 16)) >> 16


def shoup_lazy(x, w, ws, q):
    return (x * w - umulhi(x, ws) * q) & U32


def phase_index_map(log_n, r, k):
    """(n / 2^k, 2^k): value j of sub-transform u in phase (r, k)."""
    log_s = log_n - r - k
    u = torch.arange(1 << (log_n - k))
    base = ((u >> log_s) << (log_s + k)) + (u & ((1 << log_s) - 1))
    return base[:, None] + (torch.arange(1 << k) << log_s)[None]


def run_levels(xs, tw, consts, q, k, inverse, factored_from):
    """The k levels of one phase on xs (rows, n_sub, 2^k), as
    csrc/ntt_phases.cuh:radix_stages runs them: level l pairs values a and
    a + h, h = 2^(k-1-l), under slot 2^l + g of the sub-transform's root
    (tw, (rows, n_sub, slots, 2)), or, for levels from factored_from on, the
    root's slot 8 + l - FACTOR_LEVEL times the constant psi_br[g] (consts).
    Asserts the u32 invariants (< 4q forward, < 2q inverse) after every
    level."""
    rows, n_sub, e = xs.shape
    q = q.view(rows, 1, 1, 1)
    two_q = 2 * q
    for l in (reversed(range(k)) if inverse else range(k)):
        h = e >> (l + 1)
        v = xs.view(rows, n_sub, 1 << l, 2, h)
        a, b = v[..., 0, :], v[..., 1, :]
        factored = l >= factored_from
        if factored:
            slot = tw[:, :, 8 + l - FACTOR_LEVEL, None, None]
            c = consts[:, None, :1 << l, None]
        else:
            slot = tw[:, :, 1 << l:2 << l, None]
        w, ws = slot[..., 0], slot[..., 1]

        def mul(y):
            if factored:  # group 0 has the factor psi_br[0] = 1, no product
                y = torch.cat([y[:, :, :1], shoup_lazy(
                    y[:, :, 1:], c[..., 1:, :, 0], c[..., 1:, :, 1], q)], dim=2)
            return shoup_lazy(y, w, ws, q)

        if inverse:
            total = a + b
            x0 = torch.where(total >= two_q, total - two_q, total)
            x1 = mul(a + two_q - b)
        else:
            u = torch.where(a >= two_q, a - two_q, a)
            tv = mul(b)
            x0, x1 = u + tv, u + two_q - tv
        xs = torch.stack([x0, x1], dim=-2).reshape(rows, n_sub, e)
        assert (xs < (two_q if inverse else 2 * two_q).view(rows, 1, 1)).all()
    return xs


def emulate_kernel(x, t, inverse, lazy=False, n_inv=None):
    """csrc/ntt.cu's ntt_kernel on (..., L, n) residues, phase by phase, as
    csrc/ntt_phases.cuh runs them: each sub-transform's 2^k values gathered
    by the phase's index map, its k levels run with the twiddles of its root
    in kernel_phases (in the last phase the levels from FACTOR_LEVEL on
    multiply by the constant psi_br[g], then by the root's psi_br[v 2^l]),
    and scattered back (run_levels asserts the ranges).  lazy: the forward's
    values as the phases leave them in shared memory, in [0, 4q), not
    reduced to [0, q).  n_inv: the inverse's final scale per limb, n^-1 mod
    q unless given.

    With a split (t.split > 0) it replays ntt_block_kernel instead: every
    block b of 2^block_log_n values of a polynomial is one CTA's polynomial,
    with block b's slice of kernel_phases, and the inverse's scale is 1 (the
    block scalars)."""
    L, n = t.size, 1 << t.block_log_n
    s = emulate_phases(x.reshape(-1, n).clone(), t, inverse)
    rows = s.shape[0]
    limb = (torch.arange(rows) >> t.split) % L
    q2 = t.q[limb].view(rows, 1)
    if inverse:
        if n_inv is None:
            n_inv = torch.ones_like(t.n_inv) if t.split else t.n_inv
        n_inv = n_inv[limb].view(rows, 1)
        n_inv_sh = (n_inv << 32) // q2
        s = shoup_lazy(s, n_inv, n_inv_sh, q2)
        s = torch.where(s >= q2, s - q2, s)
    elif not lazy:
        s = torch.where(s >= 2 * q2, s - 2 * q2, s)
        s = torch.where(s >= q2, s - q2, s)
    return s.view(x.shape)


def emulate_phases(s, t, inverse):
    """The phases of csrc/ntt_phases.cuh on s, (rows, 2^block_log_n) values
    in place, row i the block i mod 2^split of polynomial i >> split (the
    whole polynomial without a split), as emulate_kernel describes: no
    final reduction or scale, so forward values stay in [0, 4q), inverse
    ones in [0, 2q)."""
    L, log_n = t.size, t.block_log_n
    n = 1 << log_n
    rows = s.shape[0]
    limb = (torch.arange(rows) >> t.split) % L
    block = torch.arange(rows) & ((1 << t.split) - 1)
    q = t.q[limb].view(rows, 1, 1)
    table = (t.kernel_phases.to(torch.int64) & U32)[int(inverse)].reshape(
        L << t.split, -1, 2)[(limb << t.split) + block]
    consts = table[:, :CONSTANT_SLOTS]
    assert (consts[:, 0] == 0).all()
    plan = t.phase_plan
    offs = [CONSTANT_SLOTS]
    for i, (r, k) in enumerate(plan):
        offs.append(offs[-1] + (1 << r) * phase_slots(k, i == len(plan) - 1))
    assert offs[-1] == table.shape[1] == t.entries
    order = range(len(plan))
    for p in (reversed(order) if inverse else order):
        r, k = plan[p]
        last = p == len(plan) - 1
        slots = phase_slots(k, last)
        idx = phase_index_map(log_n, r, k)
        assert torch.equal(idx.flatten().sort().values, torch.arange(n))
        if p == 0 and len(plan) > 1:
            # the inverse's store phase: sub-transforms u and u + 1 of a
            # thread hold neighbouring values, one 16-byte store a pair
            assert k <= 4 and torch.equal(idx[1::2], idx[0::2] + 1)
        root = idx[:, 0] >> (log_n - r)
        tw = table[:, offs[p] + (root[:, None] * slots) + torch.arange(slots)[None]]
        assert (tw[:, :, 0] == 0).all()  # slot 0 is padding
        s[:, idx] = run_levels(s[:, idx], tw, consts, q, k, inverse,
                               FACTOR_LEVEL if last else k)
    return s


def emulate_columns(x, t, inverse):
    """csrc/ntt.cu's ntt_columns_kernel on (..., L, n) residues: the K =
    split stages over the columns x[e n2 + j] (phase_index_map(log_n, 0, K):
    one sub-transform of root 1 per column j, so every column reads the same
    2^K slots of column_phases), a thread's columns 2j and 2j + 1 at
    neighbouring 16-byte addresses; out reduced to [0, q) (forward) or
    scaled by n^-1 (inverse)."""
    n, L, k = t.n, t.size, t.split
    s = x.reshape(-1, n).clone()
    rows = s.shape[0]
    limb = torch.arange(rows) % L
    q = t.q[limb].view(rows, 1, 1)
    table = (t.column_phases.to(torch.int64) & U32)[int(inverse)][limb].view(rows, 1, -1, 2)
    assert table.shape[2] == 1 << k and (table[:, :, 0] == 0).all()
    idx = phase_index_map(t.log_n, 0, k)
    assert torch.equal(idx[:, 0], torch.arange(n >> k))
    assert torch.equal(idx[1::2], idx[0::2] + 1)  # a thread's two columns
    s[:, idx] = run_levels(s[:, idx], table.expand(rows, n >> k, -1, 2), None, q, k,
                           inverse, k)
    q2 = q.view(rows, 1)
    if inverse:
        n_inv = t.n_inv[limb].view(rows, 1)
        s = shoup_lazy(s, n_inv, (n_inv << 32) // q2, q2)
        return torch.where(s >= q2, s - q2, s).view(x.shape)
    s = torch.where(s >= 2 * q2, s - 2 * q2, s)
    return torch.where(s >= q2, s - q2, s).view(x.shape)


def emulate_ntt(x, t, inverse):
    """One launch of ntt_kernel, or with a split the two-launch yardstick
    (ops/ntt_cuda.py:two_launch): the column and block kernels, the inverse
    in reverse.  tests/test_torch_cluster.py replays the cluster route."""
    if not t.split:
        return emulate_kernel(x, t, inverse)
    if inverse:
        return emulate_columns(emulate_kernel(x, t, True), t, True)
    return emulate_kernel(emulate_columns(x, t, False), t, False)


@pytest.mark.parametrize("log_n,L,lead", [(4, 3, (2,)), (10, 2, (2,)), (13, 3, (2,)),
                                          (15, 1, (1,))])
def test_kernel_schedule_matches_plain_and_jax(log_n, L, lead):
    """The kernel's schedule on lazy [0, 2q) input equals the plain
    transform and the JAX radix-2 transform, forward and inverse."""
    n = 1 << log_n
    primes = numth.get_primes(2 * n, 30, L)
    tt = TNTT.NTTTables(log_n, [Modulus(p) for p in primes], "cpu")
    radix2 = jax_packs(log_n, primes, pallas=False)["radix2"]
    lazy = torch.from_numpy(residues((*lead, L, n), primes, factor=2).astype(np.int64))
    canon = lazy % tt.q.view(L, 1)
    fwd = emulate_kernel(lazy, tt, inverse=False)
    assert torch.equal(fwd, TNTT.ntt_forward_plain(lazy, tt))
    np.testing.assert_array_equal(
        np.asarray(JNTT.ntt_forward(jnp.asarray(lazy.numpy().astype(np.uint32)), radix2)),
        fwd.numpy())
    inv = emulate_kernel(lazy, tt, inverse=True)
    assert torch.equal(inv, TNTT.ntt_inverse_plain(canon, tt))
    np.testing.assert_array_equal(
        np.asarray(JNTT.ntt_inverse(jnp.asarray(canon.numpy().astype(np.uint32)), radix2)),
        inv.numpy())
    assert torch.equal(emulate_kernel(fwd, tt, inverse=True), canon)


@pytest.mark.parametrize("log_n", range(1, 16))
def test_kernel_phase_plan(log_n):
    """Phases cover the stages in order, at most 5 deep, the last
    min(5, log_n) deep, every earlier one at a stride of 32 or more and the
    first of several at most 4 deep; the packed code lists the depths."""
    plan = kernel_phase_plan(log_n)
    r = 0
    for i, (ri, k) in enumerate(plan):
        assert ri == r and 1 <= k <= 5
        if i < len(plan) - 1:
            assert log_n - ri - k >= 5 and (i > 0 or k <= 4)
        r += k
    assert r == log_n and plan[-1][1] == min(5, log_n)
    code = kernel_plan_code(plan)
    assert [(code >> 4 * i) & 15 for i in range(len(plan) + 1)] == [k for _, k in plan] + [0]
    if log_n == 13:
        assert plan == [(0, 4), (4, 4), (8, 5)]


@pytest.mark.parametrize("log_n", [4, 6, 13, 14])
def test_kernel_phase_table(log_n):
    """kernel_phases holds per limb the factors psi_br[g], g < 16, then each
    phase's roots: the heap subtree of psi_br (forward) or inv_psi_br
    (inverse), in the last phase factored from FACTOR_LEVEL on; every pair
    with its Shoup companion, padding zero.  The factoring identity
    psi_br[v 2^l + g] = psi_br[v 2^l] psi_br[g] holds."""
    n = 1 << log_n
    primes = numth.get_primes(2 * n, 30, 2)
    tt = TNTT.NTTTables(log_n, [Modulus(p) for p in primes], "cpu")
    table = (tt.kernel_phases.to(torch.int64) & U32).view(2, 2, -1, 2)
    rows = (tt.psi_br, tt.inv_psi_br)
    for d, row in enumerate(rows):
        for limb, q in enumerate(primes):
            g = torch.arange(1, min(CONSTANT_SLOTS, n))
            assert torch.equal(table[d, limb, g, 0], row[limb][g])
            assert (table[d, limb, 0] == 0).all() and (table[d, limb, n:CONSTANT_SLOTS] == 0).all()
    off = CONSTANT_SLOTS
    for i, (r, k) in enumerate(tt.phase_plan):
        last = i == len(tt.phase_plan) - 1
        slots = phase_slots(k, last)
        nodes = torch.from_numpy(phase_nodes(r, k, last))
        assert nodes.shape == (1 << r, slots)
        part = table[:, :, off:off + (1 << r) * slots].reshape(2, 2, 1 << r, slots, 2)
        for d, row in enumerate(rows):
            for limb, q in enumerate(primes):
                w = row[limb][nodes]
                w[nodes == 0] = 0
                assert torch.equal(part[d, limb, ..., 0], w)
                assert torch.equal(part[d, limb, ..., 1], (w << 32) // q)
        v = (1 << r) + (1 if r else 0)   # one root: slot 2^l + g is node v 2^l + g
        for l in range(k):
            if last and l >= FACTOR_LEVEL:
                assert nodes[v - (1 << r), 8 + l - FACTOR_LEVEL] == v << l
                for limb, q in enumerate(primes):
                    for g in range(1 << l):
                        assert int(rows[0][limb][(v << l) + g]) == (
                            int(rows[0][limb][v << l]) * int(rows[0][limb][g]) % q)
            else:
                assert nodes[v - (1 << r), (1 << l):(2 << l)].tolist() == [
                    (v << l) + g for g in range(1 << l)]
        off += (1 << r) * slots
    assert table.shape[2] == off == phase_entries(log_n)


H100_SMEM_PER_CTA = 232448  # bytes of dynamic shared memory a CTA may opt into


@pytest.mark.parametrize("log_n", range(1, 16))
def test_kernel_shared_memory_fits(log_n):
    """A CTA holds the n padded values (one word in 32, rounded to 16 bytes)
    and its limb's whole table (phase_entries pairs, 16-byte aligned
    behind the values), as csrc/ntt.cu:ntt_shape sizes it: within the
    H100's limit at every n the wrapper accepts, 2 to 32768."""
    n = 1 << log_n
    primes = numth.get_primes(2 * n, 30, 1)
    tt = TNTT.NTTTables(log_n, [Modulus(p) for p in primes], "cpu")
    entries = phase_entries(log_n)
    assert tt.kernel_phases.shape[-1] == 2 * entries and entries % 2 == 0
    words = (n + (n >> 5) + 3) & ~3
    assert 4 * words + 8 * entries <= H100_SMEM_PER_CTA
    if log_n == 13:
        assert entries == 2848
