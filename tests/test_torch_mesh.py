"""The port's mesh (troy_tpu_torch/parallel/mesh.py, partition.py) against
the JAX package: a twin of each test of tests/parallel/test_mesh.py, on a
mesh of eight CPU devices ([cpu] * 8, the counterpart of XLA's eight virtual
host devices), and the port's own checks of its partition.

The inputs are the JAX package's: GeneralHeContext("BFV", 32) on 6 x 30-bit
primes, so the first level has L = 5 limbs and a (data=4, limb=2) mesh splits
them unevenly, 3 + 2 (the JAX tests use 5 primes, L = 4).  Its ciphertexts
and relinearization keys cross by troy_tpu_torch.interop; the JAX package's
single-device jit of build_mul_relin_step is the reference every sharded run
of the port must equal bit for bit, with no tolerance: (data, limb),
(host, data, limb), the one-ciphertext 'poly' mesh, the uneven splits, the
wide chain (the JAX test's (60, 40, 40, 40, 60) on its (4, 2) mesh), and
batches whose HPS alpha sums sit at float32 rounding ties.  Collective
counts and bytes come from the port's CollectiveRecord (the JAX tests read
compiled HLO)."""

import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tests.core.fixtures import GeneralHeContext
from troy_tpu.parallel.batched import BatchedEvaluator as JBatched
from troy_tpu_torch import interop
from troy_tpu_torch.core.params import EncryptionParameters, SchemeType
from troy_tpu_torch.core.coeff_modulus import CoeffModulus, PlainModulus, SecurityLevel
from troy_tpu_torch.core.context import HeContext
from troy_tpu_torch.core.keygen import KeyGenerator
from troy_tpu_torch.core.decryptor import Decryptor
from troy_tpu_torch.core.evaluator import Evaluator
from troy_tpu_torch.core.batch_encoder import BatchEncoder
from troy_tpu_torch.core.ciphertext import Ciphertext
from troy_tpu_torch.ops import ntt as NTT
from troy_tpu_torch.parallel import mesh as M, partition
from troy_tpu_torch.parallel.batched import BatchedEvaluator
from troy_tpu_torch.rns.rns_tool import F32Fold

N, BITS, B = 32, (30,) * 6, 8
WIDE_BITS = (60, 40, 40, 40, 60)
CPU8 = [torch.device("cpu")] * 8


def port_context(bits):
    p = EncryptionParameters(SchemeType.BFV).set_poly_modulus_degree(N)
    p.set_coeff_modulus(CoeffModulus.create(N, list(bits)))
    p.set_plain_modulus(PlainModulus.batching(N, 20))
    return HeContext.create(p, True, SecurityLevel.Nil, device="cpu")


class Flow:
    """The JAX package's batch of B products, its jitted single-device step
    and its output; the port's context, keys, batch and step."""

    def __init__(self):
        rng = np.random.default_rng(616)
        self.h = h = GeneralHeContext("BFV", N, log_t=20, q_bits=BITS)
        jcd = h.context.first_context_data()
        rlk = h.keygen.create_relin_keys()
        self.ms1 = [h.random_simd(rng) for _ in range(B)]
        self.ms2 = [h.random_simd(rng) for _ in range(B)]
        jb = JBatched(h.evaluator, jcd)
        self.jd1 = np.asarray(jb.stack([h.encrypt(m) for m in self.ms1]))
        self.jd2 = np.asarray(jb.stack([h.encrypt(m) for m in self.ms2]))
        self.jkey = rlk.key(2)
        self.jstep = jax.jit(jb.build_mul_relin_step(self.jkey))
        self.ref = self.jax_step(self.jd1, self.jd2)
        self.tc = tc = port_context(BITS)
        self.cd = tc.first_context_data()
        self.keys = interop.relin_keys({k: np.asarray(v) for k, v in rlk.keys.items()},
                                       tc.key_parms_id, "cpu").key(2)
        self.sk = interop.secret_key(np.asarray(h.sk.data), tc.key_parms_id, "cpu")
        self.d1 = interop.to_tensor(self.jd1, "cpu")
        self.d2 = interop.to_tensor(self.jd2, "cpu")
        self.be = BatchedEvaluator(Evaluator(tc), self.cd)
        self.step = self.be.build_mul_relin_step(self.keys)

    def jax_step(self, d1, d2) -> np.ndarray:
        return np.asarray(self.jstep(jnp.asarray(d1), jnp.asarray(d2), self.jkey))

    def run(self, mesh, shard_limbs=True, d1=None, d2=None):
        d1 = self.d1 if d1 is None else d1
        d2 = self.d2 if d2 is None else d2
        return self.step(M.shard_batch(d1, mesh, shard_limbs), M.shard_batch(d2, mesh, shard_limbs),
                         M.replicate(self.keys, mesh))

    def decrypt(self, row: torch.Tensor) -> np.ndarray:
        ct = interop.ciphertext(interop.to_numpy(row), self.cd.parms_id, "cpu")
        return BatchEncoder(self.tc).decode(Decryptor(self.tc, self.sk).decrypt(ct))


@pytest.fixture(scope="module")
def F():
    return Flow()


def same(out, ref):
    np.testing.assert_array_equal(interop.to_numpy(out.gather()), ref)


def tie_ciphertext(q: list, ip: list, wants: list, rng) -> torch.Tensor:
    """A (2, L, N) ciphertext whose HPS terms y_i = x_i ip_i mod q_i sit
    where two alpha estimates round apart: for each (pair, count) in wants,
    count coefficients at which pair(t)'s two (1, m) float32 estimates of
    the (L, m) terms t round to different integers.  The limbs but the last
    are random; the last is scanned about the value that brings
    sum_i y_i / q_i to k + 1/2."""
    cols = []
    for pair, count in wants:
        found = 0
        while found < count:
            head = [int(rng.integers(0, qi)) for qi in q[:-1]]
            s = sum(y / qi for y, qi in zip(head, q))
            c0, step = int((math.floor(s) + 1.5 - s) * q[-1]), max(1, q[-1] >> 26)
            cs = [c0 + j * step for j in range(-64, 65) if 0 <= c0 + j * step < q[-1]]
            if not cs:
                continue
            t = torch.tensor([head + [c] for c in cs], dtype=torch.int64).T
            a, b = pair(t)
            hit = (torch.round(a) != torch.round(b)).nonzero()
            if len(hit):
                cols.append(t[:, hit[0, 1]].tolist())
                found += 1
    x = [[y * pow(ip[i], -1, q[i]) % q[i] for y in col] for i, col in
         enumerate(zip(*cols))]                                          # (L, 2N)
    return torch.tensor(x, dtype=torch.int64).view(len(q), 2, N).transpose(0, 1).contiguous()


def test_sharded_mul_relin_matches_single_device(F):
    m = M.make_mesh(data=4, limb=2, devices=CPU8)
    out = F.run(m)
    same(out, F.ref)
    for i in (0, B - 1):
        np.testing.assert_array_equal(F.decrypt(out.gather()[i]),
                                      F.ms1[i] * F.ms2[i] % F.h.t)


def test_data_parallel_scaling_shapes(F):
    m = M.make_mesh(data=8, limb=1, devices=CPU8)
    d1, d2 = F.d1[:1].repeat(16, 1, 1, 1), F.d2[:1].repeat(16, 1, 1, 1)
    ds = M.shard_batch(d1, m, shard_limbs=False)
    assert ds.sharding.spec[0] == "data"
    out = F.step(ds, M.shard_batch(d2, m, shard_limbs=False), M.replicate(F.keys, m))
    assert tuple(out.shape) == (16, 2, F.cd.coeff_modulus_size, N)
    same(out, np.repeat(F.ref[:1], 16, axis=0))


def test_mesh_construction():
    m = M.make_mesh(data=2, limb=2, devices=CPU8)
    assert m.axis_names == ("data", "limb")
    assert m.devices.shape == (2, 2)
    assert m.shape == {"data": 2, "limb": 2}
    with pytest.raises(ValueError, match="need 16 devices"):
        M.make_mesh(data=8, limb=2, devices=CPU8)
    lm = M.make_latency_mesh(devices=CPU8)
    assert lm.axis_names == ("poly",) and lm.devices.shape == (8,)


def test_sharded_step_contains_collectives(F):
    """The limb-split step communicates (a plan that copied every input
    everywhere first would pass the equality test); the data-only plan
    does not."""
    stats = M.collective_stats(F.run(M.make_mesh(data=4, limb=2, devices=CPU8)))
    assert stats["total"] >= 1, stats
    assert stats["approx_bytes"] > 0
    stats1 = M.collective_stats(F.run(M.make_mesh(data=8, limb=1, devices=CPU8), False))
    assert stats1["total"] <= stats["total"]


def test_sharded_inputs_actually_partition_memory(F):
    """A shard holds 1/(data x limb) of the batch, the limbs rounded up."""
    full = F.d1.numel() * F.d1.element_size()
    ds = M.shard_batch(F.d1, M.make_mesh(data=4, limb=2, devices=CPU8))
    per = M.per_device_bytes(ds)
    # L = 5 limbs over 2 devices -> ceil(5/2) = 3 of 5 limbs on the first
    assert per <= full // 4 * 3 // 5 + 1
    assert per < full // 4
    per1 = M.per_device_bytes(M.shard_batch(F.d1, M.make_mesh(data=8, limb=1, devices=CPU8),
                                            shard_limbs=False))
    assert per1 == full // 8


def test_wide_sharded_mul_relin_matches_single_device():
    """The wide (40-60-bit) stack on the JAX test's chain and (4, 2) mesh:
    the port's (B, size, L, n), one int64 word a residue, keeps the limb
    axis second from last (the JAX layout's (hi, lo) word axis makes its
    ndim 5).  The sharded step equals the JAX package's single-device jit
    on its own ciphertexts and keys, bit for bit."""
    h = GeneralHeContext("BFV", N, log_t=20, q_bits=WIDE_BITS)
    jb = JBatched(h.evaluator, h.context.first_context_data())
    rng = np.random.default_rng(124)
    ms1 = [h.random_simd(rng) for _ in range(4)]
    ms2 = [h.random_simd(rng) for _ in range(4)]
    jd1 = np.asarray(jb.stack([h.encrypt(m) for m in ms1]))
    jd2 = np.asarray(jb.stack([h.encrypt(m) for m in ms2]))
    assert jd1.ndim == 5
    tc = port_context(WIDE_BITS)
    cd = tc.first_context_data()
    rlk = h.keygen.create_relin_keys()
    jkey = rlk.key(2)
    ref = np.asarray(jax.jit(jb.build_mul_relin_step(jkey))(jnp.asarray(jd1), jnp.asarray(jd2),
                                                             jkey))
    keys = interop.relin_keys({k: np.asarray(v) for k, v in rlk.keys.items()},
                              tc.key_parms_id, "cpu").key(2)
    d1, d2 = (interop.to_tensor(x, "cpu", wide=True) for x in (jd1, jd2))
    assert d1.ndim == 4
    step = BatchedEvaluator(Evaluator(tc), cd).build_mul_relin_step(keys)
    m = M.make_mesh(data=4, limb=2, devices=CPU8)
    out = step(M.shard_batch(d1, m), M.shard_batch(d2, m), M.replicate(keys, m))
    assert out.sharding.spec[0] == "data"
    np.testing.assert_array_equal(interop.to_numpy(out.gather(), wide=True), ref)
    assert M.collective_stats(out)["total"] >= 1
    sk = interop.secret_key(np.asarray(h.sk.data), tc.key_parms_id, "cpu")
    dec, coder = Decryptor(tc, sk), BatchEncoder(tc)
    for i in (0, 3):
        ct = Ciphertext(out.gather()[i], cd.parms_id, is_ntt_form=False)
        np.testing.assert_array_equal(coder.decode(dec.decrypt(ct)), ms1[i] * ms2[i] % h.t)


def test_multihost_data_parallel_no_dcn_traffic(F):
    """A simulated 2-host x 4-device mesh: batch parallelism moves nothing
    across hosts or devices, and a device holds 1/8 of the batch."""
    m = M.make_multihost_mesh(hosts=2, limb=1, devices=CPU8)
    assert m.axis_names == ("host", "data", "limb")
    out = F.run(m, shard_limbs=False)
    stats = M.collective_stats(out)
    assert stats["total"] == 0, f"unexpected cross-device traffic: {stats}"
    same(out, F.ref)
    full = F.d1.numel() * F.d1.element_size()
    assert M.per_device_bytes(M.shard_batch(F.d1, m, shard_limbs=False)) == full // 8


def test_multihost_limb_sharding_collectives_within_host(F):
    """(host=2, data=2, limb=2): the limb-split keyswitch communicates, and
    every group that exchanges pairs devices of one host (positions laid out
    (host, data, limb) row-major: limb partners differ by 1 and share a host
    block of 4)."""
    m = M.make_multihost_mesh(hosts=2, limb=2, devices=CPU8)
    out = F.run(m)
    assert M.collective_stats(out)["total"] >= 1
    same(out, F.ref)
    kind, gs = partition.groups(M.shard_batch(F.d1, m))
    assert kind == "limb" and len(gs) == 4
    for g in gs:
        assert len({i // 4 for i in g}) == 1, f"a group crosses hosts: {g}"
        assert g[1] - g[0] == 1


def test_poly_sharded_single_ct_latency_path(F):
    """One ciphertext, its coefficient axis over all 8 devices: the whole
    BEHZ multiply + relinearize stays bit-exact with 1/8 of the result on a
    device; the transforms' all-to-alls are in the record."""
    m = M.make_latency_mesh(devices=CPU8)
    d1s, d2s, ks = (M.shard_poly(x, m) for x in (F.d1[:1], F.d2[:1], F.keys))
    out = F.step(d1s, d2s, ks)
    stats = M.collective_stats(out)
    assert stats["counts"].get("all-to-all", 0) > 0, stats
    same(out, F.ref[:1])
    assert out.spec[-1] == "poly"
    assert M.per_device_bytes(out) == out.numel() * out.element_size() // 8


def test_limb_sharding_collective_byte_ceiling(F):
    """Batch parallelism moves no byte; (data, limb) = (4, 2) moves at most
    6x the operand's bytes a step (the JAX test's ceiling; the port counts
    every byte each receiving shard gets, a residue as a 32-bit word)."""
    operand_bytes = F.d1.numel() * F.d1.element_size()
    dp = F.run(M.make_mesh(data=8, limb=1, devices=CPU8), False)
    assert M.collective_stats(dp)["approx_bytes"] == 0
    stats = M.collective_stats(F.run(M.make_mesh(data=4, limb=2, devices=CPU8)))
    assert stats["total"] >= 1
    assert stats["approx_bytes"] <= 6 * operand_bytes, stats


# ---------------------------------------------------------------------------
# the port's own checks of the partition
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("data,limb,rows", [(4, 2, [3, 2]), (2, 3, [2, 2, 1])])
def test_uneven_limb_split(F, data, limb, rows):
    """L = 5 over 2 (3 + 2) and over 3 (2 + 2 + 1), the first shards larger:
    per_device_bytes is JAX's ceil, and the step is bit-exact."""
    m = M.make_mesh(data=data, limb=limb, devices=CPU8)
    ds = M.shard_batch(F.d1, m)
    assert [ds.shards[i].shape[-2] for i in range(limb)] == rows
    assert M.per_device_bytes(ds) == (B // data) * 2 * rows[0] * N * 8
    same(F.run(m), F.ref)


def test_limb_shards_transform_only_their_rows(F, monkeypatch):
    """Every NTT of the limb-split step covers one shard's rows (q or Bsk
    rows, the keyswitch's output rows, the special prime's row), and the
    shards together transform exactly the rows of the unsharded step: a
    partition, not a replication."""
    calls = []
    for name in ("ntt_forward", "ntt_inverse"):
        real = getattr(NTT, name)

        def rec(x, t, real=real):
            calls.append((t.size, x.numel() // x.shape[-1]))
            return real(x, t)
        monkeypatch.setattr(NTT, name, rec)
    F.step(F.d1, F.d2, F.keys)
    whole, calls[:] = list(calls), []
    F.run(M.make_mesh(data=1, limb=2, devices=CPU8))
    L, Bsk = F.cd.coeff_modulus_size, F.cd.rns_tool.base_Bsk.size
    assert max(t for t, _ in whole) == Bsk
    bound = max(-(-L // 2), -(-Bsk // 2), L // 2 + 1)
    assert bound < L and all(t <= bound for t, _ in calls), calls
    assert sum(r for _, r in calls) == sum(r for _, r in whole)


def test_hps_alpha_is_gathered(F):
    """The HPS lift's alpha = round(sum_i y_i / q_i) is a float32 fold over
    all limbs; each limb shard gathers the operand and folds in the
    unsharded order.  Ciphertext 0 holds N coefficients whose fold rounds
    one way and whose per-shard partial sums (limbs 0-2, 3-4), added, round
    the other, so a plan that reduced partial alphas would differ, and N at
    which the fold (each product fused into its addition, as XLA runs the
    JAX package's sum on the CPU) rounds otherwise than a fold that rounds
    each product.  The unsharded and the sharded step equal the JAX step on
    the whole batch."""
    tool = F.cd.rns_tool
    tabs = tool.conv_q_to_Bsk.tables
    q, ip = tabs.q_in.tolist(), tabs.ip.tolist()
    w = tool.hps_inv_q_f32.tolist()
    head, tail = F32Fold(w[:3], "cpu"), F32Fold(w[3:], "cpu")
    inv = tool.hps_inv_q_f32.view(-1, 1)

    def fold_and_partial(t):
        return tool.hps_fold(t), head(t[:3]) + tail(t[3:])

    def fold_and_plain(t):
        terms = t.to(torch.float32) * inv
        plain = terms[0:1]
        for i in range(1, t.shape[0]):
            plain = plain + terms[i:i + 1]
        return tool.hps_fold(t), plain

    d1 = F.d1.clone()
    d1[0] = tie_ciphertext(q, ip, [(fold_and_partial, N), (fold_and_plain, N)],
                           np.random.default_rng(1))
    ref = F.jax_step(interop.to_numpy(d1), F.jd2)
    np.testing.assert_array_equal(interop.to_numpy(F.step(d1, F.d2, F.keys)), ref)
    same(F.run(M.make_mesh(data=4, limb=2, devices=CPU8), d1=d1), ref)


def test_square_galois_and_batch_steps_on_a_mesh(F):
    """The square, rotation, and mod switch steps take sharded stacks too:
    square and rotate_rows over (data, limb), the mod switch over 'data'
    (no collective), each equal to its unsharded run."""
    m = M.make_mesh(data=4, limb=2, devices=CPU8)
    be = F.be
    sq = be.build_square_relin_step(F.keys)
    assert torch.equal(sq(M.shard_batch(F.d1, m), M.replicate(F.keys, m)).gather(),
                       sq(F.d1, F.keys))
    kg = KeyGenerator(F.tc)
    glk = kg.create_galois_keys()
    step, elts = be.build_rotate_rows_step(3)
    keys = tuple(glk.key(e) for e in elts)
    out = step(M.shard_batch(F.d1, m), tuple(M.replicate(k, m) for k in keys))
    assert torch.equal(out.gather(), step(F.d1, keys))
    assert M.collective_stats(out)["total"] >= len(elts)
    ms = be.build_mod_switch_step()
    mo = ms(M.shard_batch(F.d1, M.make_mesh(data=8, limb=1, devices=CPU8), False))
    assert torch.equal(mo.gather(), ms(F.d1))
    assert M.collective_stats(mo)["total"] == 0
    with pytest.raises(ValueError, match="batch shards only"):
        ms(M.shard_batch(F.d1, m))
