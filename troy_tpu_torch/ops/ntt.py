"""Negacyclic NTT/INTT over RNS limbs, for int64 residue tensors.

Counterpart of troy_tpu/ops/ntt.py.  Input is natural (coefficient) order;
output is the standard NTT order: position p holds the evaluation at
psi^(2*brv(p)+1), which the batch encoder's index map relies on.  Outputs are
canonical residues in [0, q), so they equal the JAX package's radix-2,
six-step and Pallas transforms bit for bit.

Two implementations of one function:

  * ntt_forward_plain / ntt_inverse_plain: vectorised radix-2 in PyTorch over
    int64 with `%` (reshape-only Cooley-Tukey / Gentleman-Sande stages, as in
    the JAX radix-2 path).  It serves CPU tensors, and is the reference that
    the CUDA kernel is held to.  forward_stages_plain / inverse_stages_plain
    run a range of its stages: the plain versions of each launch of the
    two-launch route below.
  * ops/ntt_cuda.py: the hand-written Hopper kernels (csrc/ntt.cu), which
    serve CUDA tensors: one launch up to n = 32768; above, a split
    (NTTTables.split, default_split) into the column and block launches.

ntt_forward / ntt_inverse dispatch on the tensor's device alone.  Callers use
them through this module's attributes (NTT.ntt_forward), never by name import.

Tables are built on the host with Python ints (NTTTables._rows copies the
JAX table builder) and moved to the context's device.  The kernel's own
twiddle layout (kernel_phase_plan, NTTTables.kernel_phases) is built here
too, in numpy, so that the CPU tests can check it.  The forward transform
accepts lazy inputs in [0, 2q): keyswitch digits arrive unreduced.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import numth
from ..core.modulus import Modulus


def _shoup(values: np.ndarray, q: int) -> np.ndarray:
    """floor(w * 2^32 / q) as u32 for residues w < q < 2^30."""
    return ((values.astype(np.uint64) << np.uint64(32)) // np.uint64(q)).astype(np.uint32)


KERNEL_MAX_DEPTH = 5  # stages one kernel phase runs in registers: 32 values


def kernel_phase_plan(log_n: int) -> list[tuple[int, int]]:
    """The NTT kernel's phases (csrc/ntt.cu): (r, k) runs the k forward
    stages m = 2^r .. 2^(r+k-1) in registers, the inverse the same stages in
    reverse.  The last phase takes min(5, log_n) stages, so that every phase
    before it reads shared memory at a stride of 32 or more (no bank
    conflicts).  Before it, a first phase of at most 4 stages (the
    inverse runs it as its last, two sub-transforms a thread, storing to
    device memory from registers), then the rest split as evenly as
    possible into phases of at most 5.
    At n = 8192: (0, 4), (4, 4), (8, 5)."""
    last = min(KERNEL_MAX_DEPTH, log_n)
    rest = log_n - last
    first = min(KERNEL_MAX_DEPTH - 1, rest)
    mid = rest - first
    count = -(-mid // KERNEL_MAX_DEPTH)
    depths = ([first] if first else []) + [
        mid // count + (i < mid % count) for i in range(count)] + [last]
    plan, r = [], 0
    for k in depths:
        plan.append((r, k))
        r += k
    return plan


def kernel_plan_code(plan: list[tuple[int, int]]) -> int:
    """The plan as the kernel reads it: depth of phase i in bits 4i..4i+3."""
    return sum(k << (4 * i) for i, (_, k) in enumerate(plan))


FACTOR_LEVEL = 3     # the last phase's levels from here on factor their twiddles
CONSTANT_SLOTS = 16  # psi_br[0 .. 15] ahead of the phases (slot 0 padding)


def phase_slots(k: int, last: bool) -> int:
    """Table slots (u32 pairs) of one sub-transform root of a phase: 2^k,
    or in a factored last phase the 2^FACTOR_LEVEL slots of the levels
    before it and two for psi_br[v 2^l], l = 3, 4 (the second padding when
    k = 4), an even count so that a root's slots load as 16-byte pairs."""
    return (1 << FACTOR_LEVEL) + 2 if last and k > FACTOR_LEVEL else 1 << k


def phase_entries(log_n: int) -> int:
    """(w, w') pairs of one limb's kernel table (phase_rows), which the
    kernel copies into shared memory: 2 848 at n = 8192."""
    plan = kernel_phase_plan(log_n)
    return CONSTANT_SLOTS + sum((1 << r) * phase_slots(k, i == len(plan) - 1)
                                for i, (r, k) in enumerate(plan))


def phase_nodes(r: int, k: int, last: bool = False) -> np.ndarray:
    """(2^r, phase_slots(k, last)) indices into a psi_br row for the phase
    (r, k): row v - 2^r serves the sub-transforms of root v.  Node m + g of
    psi_br is the twiddle of group g at stage m, and group g of level l of
    root v is node v 2^l + g.  Slot p = 2^l + g holds that node for
    l < FACTOR_LEVEL, level by level (the heap subtree of v); in the last
    phase the levels l >= FACTOR_LEVEL are factored, since
    psi_br[v 2^l + g] = psi_br[v 2^l] psi_br[g] (the bits of v 2^l and of g
    do not overlap, so their reversals add): slot 8 + l - 3 holds v 2^l, and
    the factors psi_br[g] sit once per limb ahead of the phases.  Earlier
    phases keep the whole subtree (their tables are small and shared by
    many CTAs).  Index 0 marks padding (slot 0, and slot 9 when k = 4)."""
    v = np.arange(1 << r, 2 << r)[:, None]
    depth = FACTOR_LEVEL if last and k > FACTOR_LEVEL else k
    p = np.arange(1 << depth)
    lvl = np.zeros_like(p)
    for i in range(1, depth):
        lvl += p >= (1 << i)
    nodes = (v << lvl) + p - (1 << lvl)
    nodes[:, 0] = 0
    if depth < k:
        extra = [v << l for l in range(depth, k)]
        extra += [np.zeros_like(v)] * (phase_slots(k, last) - (1 << depth) - len(extra))
        nodes = np.concatenate([nodes, *extra], axis=1)
    return nodes


def phase_rows(row: np.ndarray, row_shoup: np.ndarray, log_n: int,
               split: int = 0) -> np.ndarray:
    """One limb's kernel twiddles, as (w, floor(w 2^32 / q)) u32 pairs, so
    that a thread loads two slots as one 16-byte vector: CONSTANT_SLOTS
    factors psi_br[g] (zero where g >= n), then every phase of
    kernel_phase_plan back to back (phase_nodes), padding (0, 0).

    With a split (the two-launch route, NTTTables.split), log_n is a block's
    and the table repeats per block b < 2^split: the block kernel's phase
    (r, k) runs global stages from split + r, where block b holds the roots
    v = 2^(split+r) + b 2^r + u, u < 2^r, so block b's rows of
    phase_nodes(split + r, k) are its own."""
    n_blocks = 1 << split
    g = np.arange(min(CONSTANT_SLOTS, 1 << log_n))
    consts = np.zeros((CONSTANT_SLOTS, 2), np.uint32)
    consts[1:len(g)] = np.stack([row[g], row_shoup[g]], axis=-1)[1:]
    parts = [np.broadcast_to(consts, (n_blocks, CONSTANT_SLOTS, 2))]
    plan = kernel_phase_plan(log_n)
    for i, (r, k) in enumerate(plan):
        nodes = phase_nodes(split + r, k, last=i == len(plan) - 1)
        pair = np.stack([row[nodes], row_shoup[nodes]], axis=-1)
        pair[nodes == 0] = 0
        parts.append(pair.reshape(n_blocks, -1, 2))
    return np.concatenate(parts, axis=1).reshape(-1).astype(np.uint32)


def column_rows(row: np.ndarray, row_shoup: np.ndarray, split: int) -> np.ndarray:
    """The column kernel's 2^split (w, w') slots: the heap subtree of root 1
    (phase_nodes(0, split)), slot p = psi_br[p] for 0 < p < 2^split, slot 0
    padding; empty without a split."""
    if not split:
        return np.zeros(0, np.uint32)
    nodes = phase_nodes(0, split)[0]
    pair = np.stack([row[nodes], row_shoup[nodes]], axis=-1)
    pair[nodes == 0] = 0
    return pair.reshape(-1).astype(np.uint32)


MAX_LOG_N = 17        # the reference's largest degree, 131072
BLOCK_MAX_LOG_N = 15  # a CTA holds at most 32768 values and their table
LARGE_BLOCK_LOG_N = 12  # the block of the two-launch route (PERF.md, F3)


def default_split(log_n: int) -> int:
    """log2 n1 of the route NTTTables takes by default: 0 (one launch, a
    polynomial a CTA) up to n = 32768, else n = n1 n2 with n2 = 4096 (the
    faster of blocks of 4096, 8192 and 32768 on the H100, PERF.md), at most
    5 (the kernels take no degree above 131072)."""
    if log_n <= BLOCK_MAX_LOG_N:
        return 0
    return min(KERNEL_MAX_DEPTH, log_n - LARGE_BLOCK_LOG_N)


class NTTTables:
    """Per-(n, modulus-list) twiddle tables on one device.

    Plain-version tensors (int64):
      q (L,), psi_br / inv_psi_br (L, n) psi^brv(i) and their inverses,
      n_inv (L,).
    Kernel tensors (u32 bit patterns stored as int32):
      kernel_rows (4, L, n): psi_br, its Shoup companion, inv_psi_br, its
        Shoup companion;
      kernel_scalars (6, L): q, n^-1, the Shoup companion of n^-1 (the NTT
        kernel's), then the fused tensor product's (csrc/fused_mul.cu):
        -q^-1 mod 2^32, n^-1 2^32 mod q and its Shoup companion;
      kernel_phases (2, L, 2 E): phase_rows of psi_br and of inv_psi_br per
        limb, E entries each (the NTT kernel's twiddles); with a split,
        (2, L, 2^split 2 E), E entries per block;
      phase_plan / plan_code: kernel_phase_plan(block_log_n) and its packed
        form;
      column_phases (2, L, 2^(split+1)): column_rows of psi_br and of
        inv_psi_br (the column kernel's twiddles; empty without a split);
      block_scalars (3, L): q, 1 and floor(2^32 / q), the block kernel's
        inverse scale (a reduction to [0, q));
      barrett_ratio (L,) int64: floor((2^64 - 1) / q), for the tensor
        product of csrc/tensor_product.cu.
    split (log2 n1) picks the kernels' route: 0, one launch of a polynomial
    a CTA; above, two launches over n = n1 n2, blocks of 2^block_log_n
    values (csrc/ntt.cu).  default_split(log_n) unless given.
    """

    _row_cache: dict = {}  # (log_n, q, split) -> per-modulus host rows

    @classmethod
    def _rows(cls, log_n: int, mod: Modulus, split: int) -> dict:
        key = (log_n, mod.value, split)
        if key in cls._row_cache:
            return cls._row_cache[key]
        n = 1 << log_n
        q = mod.value
        psi = numth.try_minimal_primitive_root(2 * n, q)
        if psi is None:
            raise ValueError(
                f"[NTTTables] modulus {q} does not support NTT of degree {n}")
        ipsi = numth.invert_mod(psi, q)
        brv = [numth.reverse_bits(i, log_n) for i in range(n)]
        fwd = np.zeros(n, dtype=np.uint32)
        inv = np.zeros(n, dtype=np.uint32)
        p, ip = 1, 1
        for i in range(n):
            fwd[brv[i]] = p
            inv[brv[i]] = ip
            p = p * psi % q
            ip = ip * ipsi % q
        ninv = numth.invert_mod(n, q)
        ninv_mont = (ninv << 32) % q
        fwd_sh, inv_sh = _shoup(fwd, q), _shoup(inv, q)
        rows = dict(psi_br=fwd, psi_br_shoup=fwd_sh,
                    inv_psi_br=inv, inv_psi_br_shoup=inv_sh,
                    n_inv=ninv, n_inv_shoup=(ninv << 32) // q,
                    q_inv_neg=(-pow(q, -1, 1 << 32)) % (1 << 32),
                    n_inv_mont=ninv_mont, n_inv_mont_shoup=(ninv_mont << 32) // q,
                    phases=np.stack([phase_rows(fwd, fwd_sh, log_n - split, split),
                                     phase_rows(inv, inv_sh, log_n - split, split)]),
                    columns=np.stack([column_rows(fwd, fwd_sh, split),
                                      column_rows(inv, inv_sh, split)]))
        cls._row_cache[key] = rows
        return rows

    def __init__(self, log_n: int, moduli: list[Modulus], device,
                 split: int | None = None):
        self.log_n = log_n
        self.n = 1 << log_n
        self.moduli = list(moduli)
        self.device = torch.device(device)
        self.split = default_split(log_n) if split is None else split
        if self.split and not 1 <= self.split <= min(KERNEL_MAX_DEPTH, log_n - 1):
            raise ValueError(f"[NTTTables] split {self.split} outside [1, 5] or "
                             f"not below log2 n = {log_n}")
        self.block_log_n = log_n - self.split
        self.phase_plan = kernel_phase_plan(self.block_log_n)
        self.plan_code = kernel_plan_code(self.phase_plan)
        rows = [self._rows(log_n, m, self.split) for m in moduli]
        q = np.array([m.value for m in moduli], dtype=np.int64)
        kernel_rows = np.stack([
            np.stack([r[k] for r in rows])
            for k in ("psi_br", "psi_br_shoup", "inv_psi_br", "inv_psi_br_shoup")])
        kernel_scalars = np.array(
            [q, *[[r[k] for r in rows] for k in ("n_inv", "n_inv_shoup", "q_inv_neg",
                                                  "n_inv_mont", "n_inv_mont_shoup")]],
            dtype=np.uint64).astype(np.uint32)
        self._set(
            q=torch.from_numpy(q),
            psi_br=torch.from_numpy(kernel_rows[0].astype(np.int64)),
            inv_psi_br=torch.from_numpy(kernel_rows[2].astype(np.int64)),
            n_inv=torch.tensor([r["n_inv"] for r in rows], dtype=torch.int64),
            kernel_rows=torch.from_numpy(kernel_rows.view(np.int32)),
            kernel_scalars=torch.from_numpy(kernel_scalars.view(np.int32)),
            kernel_phases=torch.from_numpy(
                np.stack([r["phases"] for r in rows], axis=1).view(np.int32)),
            column_phases=torch.from_numpy(
                np.stack([r["columns"] for r in rows], axis=1).view(np.int32)),
            block_scalars=torch.from_numpy(np.array(
                [q, np.ones_like(q), (1 << 32) // q], dtype=np.uint64
            ).astype(np.uint32).view(np.int32)),
            barrett_ratio=torch.tensor([((1 << 64) - 1) // int(v) for v in q],
                                       dtype=torch.int64),
        )

    def _set(self, **tensors):
        for k, v in tensors.items():
            setattr(self, k, v.to(self.device).contiguous())

    @property
    def size(self) -> int:
        return len(self.moduli)

    @property
    def max_modulus(self) -> int:
        return max(m.value for m in self.moduli)

    @property
    def entries(self) -> int:
        """Table pairs of one limb (of one block, with a split)."""
        return phase_entries(self.block_log_n)

    def take(self, idx: list[int]) -> "NTTTables":
        """Tables for the limb rows idx (e.g. a level's moduli plus the
        special prime, for the keyswitch output base)."""
        out = object.__new__(NTTTables)
        out.log_n, out.n, out.device = self.log_n, self.n, self.device
        out.split, out.block_log_n = self.split, self.block_log_n
        out.phase_plan, out.plan_code = self.phase_plan, self.plan_code
        out.moduli = [self.moduli[i] for i in idx]
        ix = torch.tensor(idx, dtype=torch.int64, device=self.device)
        out._set(q=self.q[ix], psi_br=self.psi_br[ix],
                 inv_psi_br=self.inv_psi_br[ix], n_inv=self.n_inv[ix],
                 kernel_rows=self.kernel_rows[:, ix],
                 kernel_scalars=self.kernel_scalars[:, ix],
                 kernel_phases=self.kernel_phases[:, ix],
                 column_phases=self.column_phases[:, ix],
                 block_scalars=self.block_scalars[:, ix],
                 barrett_ratio=self.barrett_ratio[ix])
        return out


# ---------------------------------------------------------------------------
# Plain PyTorch versions.  x has shape (..., L, n); t is an NTTTables.
# ---------------------------------------------------------------------------

def forward_stages_plain(x: torch.Tensor, t: NTTTables, first: int,
                         stop: int) -> torch.Tensor:
    """The forward stages m = 2^first .. 2^(stop-1) along the last axis:
    Cooley-Tukey stages with m groups each, the flat (..., n) axis viewed as
    (..., m, 2, n/2m).  In: [0, 2q), the kernel's contract: one conditional
    subtract brings it to [0, q), so input of 2q or more comes out wrong here
    as it may on the card.  Out: [0, q)."""
    n, L = x.shape[-1], x.shape[-2]
    lead = x.shape[:-2]
    q = t.q.view(L, 1, 1)
    x = torch.where(x >= t.q.view(L, 1), x - t.q.view(L, 1), x)
    for r in range(first, stop):
        m = 1 << r
        xr = x.reshape(*lead, L, m, 2, n // (2 * m))
        u, v = xr[..., 0, :], xr[..., 1, :]
        tv = v * t.psi_br[:, m:2 * m, None] % q
        x0 = u + tv
        x0 = torch.where(x0 >= q, x0 - q, x0)
        x1 = u - tv
        x1 = torch.where(x1 < 0, x1 + q, x1)
        x = torch.stack([x0, x1], dim=-2).reshape(*lead, L, n)
    return x


def inverse_stages_plain(x: torch.Tensor, t: NTTTables, first: int, stop: int,
                         scale: bool) -> torch.Tensor:
    """The inverse (Gentleman-Sande) stages m = 2^(stop-1) down to 2^first
    along the last axis, then the n^-1 scale if `scale`.  In: [0, q); out:
    [0, q)."""
    n, L = x.shape[-1], x.shape[-2]
    lead = x.shape[:-2]
    q = t.q.view(L, 1, 1)
    for r in reversed(range(first, stop)):
        m = 1 << r
        xr = x.reshape(*lead, L, m, 2, n // (2 * m))
        u, v = xr[..., 0, :], xr[..., 1, :]
        x0 = u + v
        x0 = torch.where(x0 >= q, x0 - q, x0)
        x1 = (u + q - v) * t.inv_psi_br[:, m:2 * m, None] % q
        x = torch.stack([x0, x1], dim=-2).reshape(*lead, L, n)
    return x * t.n_inv.view(L, 1) % t.q.view(L, 1) if scale else x


def ntt_forward_plain(x: torch.Tensor, t: NTTTables) -> torch.Tensor:
    """Forward negacyclic NTT along the last axis, every stage.  In: [0, 2q)
    natural order; out: [0, q) NTT order."""
    return forward_stages_plain(x, t, 0, t.log_n)


def ntt_inverse_plain(x: torch.Tensor, t: NTTTables) -> torch.Tensor:
    """Inverse negacyclic NTT along the last axis, scaled by n^-1.  In:
    [0, q) NTT order; out: [0, q) natural order."""
    return inverse_stages_plain(x, t, 0, t.log_n, scale=True)


# ---------------------------------------------------------------------------
# Dispatch: a CPU tensor takes the plain version, a CUDA tensor the kernel.
# ---------------------------------------------------------------------------

def ntt_forward(x: torch.Tensor, t: NTTTables) -> torch.Tensor:
    """Forward NTT of (..., L, n) residues in [0, 2q) -> [0, q) NTT order."""
    if x.is_cuda:
        from . import ntt_cuda

        return ntt_cuda.ntt_forward(x, t)
    return ntt_forward_plain(x, t)


def ntt_inverse(x: torch.Tensor, t: NTTTables) -> torch.Tensor:
    """Inverse NTT of (..., L, n) residues in [0, q) -> [0, q) natural order."""
    if x.is_cuda:
        from . import ntt_cuda

        return ntt_cuda.ntt_inverse(x, t)
    return ntt_inverse_plain(x, t)


def slice_tables(t: NTTTables, lo: int, hi: int) -> NTTTables:
    """The tables of limb rows [lo, hi)."""
    return t.take(list(range(lo, hi)))


def take_tables(t: NTTTables, idx) -> NTTTables:
    """The tables of the limb rows idx."""
    return t.take(list(idx))


def ntt(x: torch.Tensor, t: NTTTables) -> torch.Tensor:
    """The JAX package's short name of ntt_forward."""
    return ntt_forward(x, t)


def intt(x: torch.Tensor, t: NTTTables) -> torch.Tensor:
    """The JAX package's short name of ntt_inverse."""
    return ntt_inverse(x, t)
