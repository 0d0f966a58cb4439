"""The port's public names against the JAX package's, module by module and
class by class (the evaluator's own test is in test_torch_eval_surface.py).

For each module of the port with a JAX counterpart: every public function
or class the JAX module defines (or binds, as ops/rp binds poly's add) is on
the port's module, and every class's public names are on the port's class,
but for LEFT_OUT, the names the port leaves out on purpose, each with its
reason; and every public function or class the port module defines, and
every public name of its classes, is the JAX package's or in PORT_ONLY,
with its reason.  The JAX package's ops/jitu.py (the TPU jit helpers) and
ops/ddfft.py (double-double FFT arithmetic; the port's device CKKS encoder
runs torch.fft in float64) are modules the port does not have."""

import importlib
import inspect

import numpy as np
import pytest
import torch

MODULES = (
    [f"core.{m}" for m in ("batch_encoder", "ciphertext", "ckks_encoder", "coeff_modulus",
                           "context", "decryptor", "encryptor", "evaluator", "keygen", "keys",
                           "lwe", "lwe_ops", "modulus", "params", "plaintext", "rlwe")]
    + ["rns.rns_base", "rns.rns_tool", "rns.rns_tool64", "rns.scaling",
       "parallel.batched", "parallel.mesh", "utils.random", "utils.serialize", "utils.timer",
       "utils.poly_string", "ops.reduction",
       "ops.poly", "ops.galois", "ops.ntt", "ops.ntt_mxu", "ops.u64", "ops.ntt64", "ops.rp",
       "ops.limb"]
    + [f"app.{m}" for m in ("cipher2d", "conv2d", "encoder_adapter", "matmul", "ring2k")])

# JAX names the port leaves out: (module, class or None) -> {name: reason}
BACKEND_KNOB = "a backend knob of the TPU kernels; the port dispatches on the device"
TABLE_PACK = "a TPU table pack (jnp pytree); the port's tables are device tensors"
SIXSTEP = "the six-step NTT is a TPU lane layout, not ported (ROADMAP A2-A4)"
LEFT_OUT = {
    ("rns.rns_base", None): {"get_bconv_backend": BACKEND_KNOB,
                             "set_bconv_backend": BACKEND_KNOB},
    ("rns.rns_base", "RNSBase"): {"pack": TABLE_PACK},
    ("rns.rns_tool", "RNSTool"): {
        "fast_floor_fast_b_conv_sk": "the unfused floor; the folded floor equals it "
                                     "(ROADMAP A5, test_torch_rns.py)",
        "materialize": TABLE_PACK},
    ("rns.rns_tool64", "RNSTool64"): {
        "fast_floor_fast_b_conv_sk": "the unfused floor; the folded floor equals it",
        "materialize": TABLE_PACK},
    ("ops.poly", None): {"scalar_pack": TABLE_PACK},
    ("ops.ntt", None): {"ntt_forward_sixstep": SIXSTEP, "ntt_inverse_sixstep": SIXSTEP},
    ("ops.ntt", "NTTTables"): {"host": TABLE_PACK, "pack": TABLE_PACK},
    ("ops.ntt_mxu", "MxuNTTTables"): {"pack": TABLE_PACK, "pack_prefixed": TABLE_PACK},
    ("ops.u64", None): {"mul64_wide_k": "a measured negative on the TPU (ROADMAP)"},
    ("ops.ntt64", None): {"ntt_forward64_sixstep": SIXSTEP, "ntt_inverse64_sixstep": SIXSTEP},
    ("ops.ntt64", "NTT64Tables"): {"pack": TABLE_PACK},
}

# the port's own public names: (module, class or None) -> {name: reason}
KERNEL_LAYOUT = "the Hopper kernels' table layout and plain versions (ops/ntt.py)"
PORT_ONLY = {
    ("core.ciphertext", "Ciphertext"): {"data": "a property: new data drops the seed"},
    ("core.plaintext", None): {"is_rns_form": "RNS or mod-t form, at either width "
                                              "(one layout: the JAX package reads ndim)"},
    ("core.decryptor", "Decryptor"): {
        "phase_coeff": "the phase helpers the BatchedClient decrypt shares",
        "phase_ntt": "the phase helpers the BatchedClient decrypt shares"},
    ("core.encryptor", "Encryptor"): {
        "plain_payload": "the message term the BatchedClient encrypt steps share"},
    ("rns.rns_tool", None): {"LastPrimeTool": "the CKKS level's tool: the last-prime "
                                              "divisions without t",
                             "F32Fold": "the HPS estimate's float32 sum as XLA fuses the "
                                        "JAX package's jnp.sum, in int64 fixed point"},
    ("utils.random", None): {
        **{n: "jax.random's threefry, written out in torch (JAX uses jax.random)"
           for n in ("bits", "fold_in", "key", "threefry2x32")},
        **{n: "the samplers' bodies on given bits"
           for n in ("cbd_from_bits", "ternary_from_bits", "uniform_from_bits")},
        **{n: "the samplers for a RandomGenerator or a torch.Generator"
           for n in ("new_seed", "sample_cbd", "sample_ternary", "sample_uniform", "stream")}},
    ("utils.random", "RandomGenerator"): {"aes_words": "the AES-CTR words (private in JAX)"},
    ("utils.timer", None): {
        "span": "the port's ranges on the torch.profiler trace (a flag check when off)",
        **{n: "the hand-written kernels' launch counters, read and reset together"
           for n in ("launch_counts", "reset_launch_counts")}},
    ("ops.galois", "GaloisTool"): {"coeff_table": "the cached permutation tables",
                                   "ntt_table": "the cached permutation tables"},
    ("ops.ntt", None): {n: KERNEL_LAYOUT for n in (
        "column_rows", "default_split", "forward_stages_plain", "inverse_stages_plain",
        "kernel_phase_plan", "kernel_plan_code", "ntt_forward_plain", "ntt_inverse_plain",
        "phase_entries", "phase_nodes", "phase_rows", "phase_slots")},
    ("ops.ntt", "NTTTables"): {n: "table accessors (JAX packs are dicts)"
                               for n in ("entries", "max_modulus", "size", "take")},
    ("ops.ntt_mxu", None): {
        "kernel_plan": "the Hopper kernel's launches, tiles and K chunks (csrc/ntt_mxu.cu)",
        "plain_tables": "the kernel-layout tables under the JAX names, for the plain version",
        **{n: "the recombination's parts, which the kernel-schedule emulation reuses"
           for n in ("recombine_diagonals", "shoup_lazy")},
        **{n: "the int32 bounds asserted at table build"
           for n in ("check_int32", "diagonal_bounds")},
        "wg_plan": "the redesigned kernel's shared-memory plan (csrc/ntt_mxu_wg.cu)",
        "cl_plan": "the cluster kernel's cut of a stage across a cluster (csrc/ntt_mxu_cluster.cu)",
        "cl_layout": "the cluster kernel's table layout (64 x 64 blocks: a chunk one run)",
        **{n: "the redesigned kernel's table layout (wgmma core matrices) and constants"
           for n in ("wg_layout", "wg_unlayout", "wg_scalar_rows")},
        **{n: "the unsigned planes' bounds and Barrett step, asserted at table build"
           for n in ("byte_bounds", "wg_diagonal_bounds", "wg_barrett")}},
    ("ops.ntt_mxu", "MxuNTTTables"): {n: "table accessors (JAX packs are dicts)"
                                      for n in ("max_modulus", "size", "take")},
    ("rns.rns_tool64", None): {
        "F32FmaSum": "the wide HPS estimate's float32 sum in the order XLA's CPU code "
                     "gives the JAX package's jitted lift",
        "fma32": "float32 fma, exact in float64 (F32FmaSum's step)",
        "add32": "float32 add, exact in float64 (F32FmaSum's step)"},
    ("ops.u64", None): {"barrett_consts": "the port's Barrett tuple (2^62 split)",
                        "shoup62": "the port's Shoup companion floor(w 2^62 / q)"},
    ("ops.ntt64", None): {"WideScalarTables": "what wide_scalar_pack returns"},
    ("ops.ntt64", "NTT64Tables"): {n: "table accessors and the width marker"
                                   for n in ("max_modulus", "size", "take", "words")},
    ("ops.rp", None): {"mul_mod": "a per-limb product by constants at either width"},
    ("parallel.mesh", None): {
        "Mesh": "jax.sharding.Mesh's counterpart (torch devices, named axes, ranks)",
        "Sharding": "NamedSharding's counterpart: a mesh and a PartitionSpec tuple",
        "ShardedTensor": "the sharded jax.Array's counterpart: one contiguous shard a "
                         "mesh device, gathered by .gather()",
        "CollectiveRecord": "what collective_stats reads: the explicit partition's copies "
                            "(the JAX function reads a compiled executable's HLO)",
        "recording": "collects the records of every step inside a with block (the "
                     "object API's mesh= paths return plain tensors)",
        "shard": "jax.device_put with a NamedSharding",
        "shard_slices": "the piece of each axis a mesh position holds",
        "split": "the uneven split rule, the first shards larger"},
}

# functions whose parameters differ from the JAX package's: name -> reason
SIGNATURES = {
    ("parallel.mesh", "collective_stats"): "takes a CollectiveRecord or a sharded result, "
                                           "not a compiled executable (there is no HLO)",
}


def _defined(mod) -> set:
    return {n for n, v in vars(mod).items() if not n.startswith("_")
            and (inspect.isfunction(v) or inspect.isclass(v))
            and getattr(v, "__module__", None) == mod.__name__}


def _public(cls) -> set:
    return {n for n in dir(cls) if not n.startswith("_")}


@pytest.mark.parametrize("name", MODULES)
def test_public_names_match_jax(name):
    jmod = importlib.import_module("troy_tpu." + name)
    tmod = importlib.import_module("troy_tpu_torch." + name)
    jnames = _defined(jmod)
    left = LEFT_OUT.get((name, None), {})
    missing = {n for n in jnames - set(left) if not hasattr(tmod, n)}
    assert not missing, f"{name}: not on the port: {sorted(missing)}"
    extra = _defined(tmod) - jnames - set(PORT_ONLY.get((name, None), {}))
    assert not extra, f"{name}: the port's own, unlisted: {sorted(extra)}"
    for n in sorted(jnames - set(left)):
        jv, tv = getattr(jmod, n), getattr(tmod, n)
        if not inspect.isclass(jv):
            continue
        assert inspect.isclass(tv), f"{name}.{n} is a class in the JAX package"
        cleft = set(LEFT_OUT.get((name, n), {}))
        cmissing = _public(jv) - _public(tv) - cleft
        assert not cmissing, f"{name}.{n}: not on the port: {sorted(cmissing)}"
        cextra = _public(tv) - _public(jv) - set(PORT_ONLY.get((name, n), {}))
        assert not cextra, f"{name}.{n}: the port's own, unlisted: {sorted(cextra)}"
    for (mod, cls), names in LEFT_OUT.items():
        if mod == name:     # every listed name really is the JAX package's
            owner = jmod if cls is None else getattr(jmod, cls)
            assert all(hasattr(owner, k) for k in names), (mod, cls)


def test_mesh_signatures_against_jax():
    """The mesh's functions take the JAX module's parameters, but for
    SIGNATURES."""
    from troy_tpu.parallel import mesh as JM
    from troy_tpu_torch.parallel import mesh as TM

    names = _defined(JM)
    assert len(names) == 11
    for n in sorted(names):
        if ("parallel.mesh", n) in SIGNATURES:
            continue
        jp = list(inspect.signature(getattr(JM, n)).parameters)
        tp = list(inspect.signature(getattr(TM, n)).parameters)
        assert tp == jp, (n, tp, jp)
    assert list(inspect.signature(TM.collective_stats).parameters) == ["record"]


def test_left_out_names_stay_out():
    """A name listed as left out is not on the port (the lists stay true)."""
    for (mod, cls), names in LEFT_OUT.items():
        tmod = importlib.import_module("troy_tpu_torch." + mod)
        owner = tmod if cls is None else getattr(tmod, cls)
        assert not any(hasattr(owner, k) for k in names), (mod, cls)


# ---------------------------------------------------------------------------
# parity of the names that closed the surface gaps
# ---------------------------------------------------------------------------

def test_parameter_names_against_jax():
    from troy_tpu.core import modulus as JM, coeff_modulus as JC
    from troy_tpu_torch.core import modulus as TM, coeff_modulus as TC

    for q in (65537, (1 << 29) + 11, (1 << 40) - 87, (1 << 61) - 1):
        jm, tm = JM.Modulus(q), TM.Modulus(q)
        assert (tm.fits_wide_path(), tm.is_zero, tm.reduce(q + 5), tm.pow(3, 77),
                tm.invert(12345), tm.shoup(q - 2)) == \
            (jm.fits_wide_path(), jm.is_zero, jm.reduce(q + 5), jm.pow(3, 77),
             jm.invert(12345), jm.shoup(q - 2))
    assert [m.value for m in TM.make_moduli([3, 5])] == [m.value for m in JM.make_moduli([3, 5])]
    assert TM.Modulus(0).is_zero
    assert [m.value for m in TC.CoeffModulus.bfv_default(4096)] == \
        [m.value for m in JC.CoeffModulus.bfv_default(4096)]
    assert [m.value for m in TC.PlainModulus.batching_multiple(64, [20, 21, 20])] == \
        [m.value for m in JC.PlainModulus.batching_multiple(64, [20, 21, 20])]


@pytest.fixture(scope="module")
def P():
    from .test_torch_lwe import Pair

    return Pair("BFV", n=64, bits=[30, 30, 30, 30], seed=0x5AF)


def test_object_names_against_jax(P):
    from troy_tpu_torch.core.context import EncryptionParameterQualifiers
    from .test_torch_client import same

    assert P.tc.parameters_set() and P.jc.parameters_set()
    for jcd, cd in ((P.jc.first_context_data(), P.tc.first_context_data()),
                    (P.jc.key_context_data(), P.tc.key_context_data())):
        assert vars(cd.qualifiers) == vars(jcd.qualifiers)
        assert isinstance(cd.qualifiers, EncryptionParameterQualifiers)
        assert cd.wide is False and jcd.wide is False
    m = [np.random.default_rng(3).integers(0, P.t, 64, dtype=np.uint64) for _ in range(2)]
    jpts, pts = zip(*(P.encode(v) for v in m))
    jcts = P.jencr.encrypt_asymmetric_batched(list(jpts))
    cts = P.encr.encrypt_asymmetric_batched(list(pts))
    for jct, ct in zip(jcts, cts):
        same(jct.data, ct.data)
        assert (ct.coeff_modulus_size, ct.poly_modulus_degree, ct.wide) == \
            (jct.coeff_modulus_size, jct.poly_modulus_degree, jct.wide)
        same(jct.poly(1), ct.poly(1))
    for jpt, pt in zip(P.jdec.decrypt_batched(jcts), P.dec.decrypt_batched(cts)):
        same(jpt.data, pt.data)
        assert pt.coeff_modulus_size == jpt.coeff_modulus_size
    sk = P.kg.secret_key.clone()
    assert sk is not P.kg.secret_key and sk.data is P.kg.secret_key.data
    from troy_tpu_torch.core.keys import GaloisKeys
    from troy_tpu.core.keys import GaloisKeys as JG
    assert GaloisKeys.get_index(7) == JG.get_index(7) == 7


def test_rns_and_poly_names_against_jax(P):
    from troy_tpu.ops import poly as JP, ntt as JN
    from troy_tpu_torch.ops import poly as TP, ntt as TN
    from .test_torch_client import same
    import jax.numpy as jnp

    jcd, cd = P.jc.first_context_data(), P.tc.first_context_data()
    jb, b = jcd.base_q, cd.base_q
    v = [12345678901234567, b.prod - 1, b.prod // 2]
    for x in v:
        assert b.decompose(x) == jb.decompose(x)
        assert b.compose(b.decompose(x)) == jb.compose(jb.decompose(x)) == x
        assert b.compose_centered(b.decompose(x)) == jb.compose_centered(jb.decompose(x))
    np.testing.assert_array_equal(b.residues_host(v), jb.residues_host(v))
    from troy_tpu.rns.rns_base import BaseConverter as JBC
    from troy_tpu_torch.rns.rns_base import BaseConverter as TBC
    jconv, conv = JBC(jb, P.jc.last_context_data().base_q), \
        TBC(b, P.tc.last_context_data().base_q)
    x = np.stack([np.random.default_rng(i).integers(0, q, 64) for i, q in
                  enumerate(b.values)]).astype(np.uint32)
    xt = torch.from_numpy(x.astype(np.int64))
    same(jconv.convert_single_limb(jnp.asarray(x)), conv.convert_single_limb(xt))
    jq, tq = jcd.qtab(), cd.qtab()
    w = [int(q) - 3 for q in b.values]
    ws = [(wi << 32) // q for wi, q in zip(w, b.values)]
    same(JP.multiply_operand(jnp.asarray(x), jnp.asarray(np.array(w, np.uint32)),
                             jnp.asarray(np.array(ws, np.uint32)), jq),
         TP.multiply_operand(xt, torch.tensor(w), torch.tensor(ws), tq))
    same(JP.negacyclic_multiply_monomial(jnp.asarray(x), 7, 5, jq),
         TP.negacyclic_multiply_monomial(xt, 7, 5, tq))
    big = (x.astype(np.uint64) * 3 + 7).astype(np.uint32)
    same(JP.modulo(jnp.asarray(big), jq), TP.modulo(torch.from_numpy(big.astype(np.int64)), tq))
    same(JP.reduce_from_limb(jnp.asarray(big[0]), jq),
         TP.reduce_from_limb(torch.from_numpy(big[0].astype(np.int64)), tq))
    same(JN.ntt(jnp.asarray(x), jq), TN.ntt(xt, tq))
    same(JN.intt(jnp.asarray(x), jq), TN.intt(xt, tq))
    same(JN.ntt(jnp.asarray(x[1:3]), JN.slice_tables(jq, 1, 3)),
         TN.ntt(xt[1:3], TN.slice_tables(tq, 1, 3)))
    same(JN.ntt(jnp.asarray(x[[2, 0]]), JN.take_tables(jq, [2, 0])),
         TN.ntt(xt[[2, 0]], TN.take_tables(tq, [2, 0])))


def test_wire_u32_against_jax():
    from troy_tpu.utils import serialize as JS
    from troy_tpu_torch.utils import serialize as TS

    jw, tw = JS.Writer(), TS.Writer()
    for v in (0, 1, 0xFFFFFFFF, 123456789):
        jw.u32(v)
        tw.u32(v)
    assert jw.getvalue() == tw.getvalue()
    r = TS.Reader(jw.getvalue())
    assert [r.u32() for _ in range(4)] == [0, 1, 0xFFFFFFFF, 123456789]


def test_top_level_names_match_jax():
    """The package's lazy names (PEP 562): __all__ and the _API map equal
    the JAX package's, each at the same module path, and every name
    resolves to the port's own object."""
    import troy_tpu
    import troy_tpu_torch

    assert troy_tpu_torch.__all__ == troy_tpu.__all__
    assert troy_tpu_torch._API == troy_tpu._API
    for name in troy_tpu_torch.__all__:
        obj = getattr(troy_tpu_torch, name)
        assert obj.__module__ == "troy_tpu_torch." + troy_tpu_torch._API[name], name
        assert obj is getattr(importlib.import_module(obj.__module__), name)
    with pytest.raises(AttributeError, match="troy_tpu_torch"):
        troy_tpu_torch.NoSuchName

