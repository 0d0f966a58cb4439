"""BumbleBee-style ciphertext-plaintext matrix multiplication (counterpart
of troy_tpu/app/matmul.py), with the reference's packing layout:

  blocks (bb, ib, ob) with bb * ib * ob <= n chosen by a cost-model search;
  input poly  [di][dj]:  coeff[(i-li)*ib*ob + (j-lj)]           = x[i, j]
  weight poly [dj][dk]:  coeff[(k-lk)*ib + ib-1-(j-lj)]         = w[j, k]
  product:    coeff[(i-li)*ib*ob + (k-lk)*ib + ib-1]            = sum_j x w

so one multiply_plain_contract computes every (bb x ob) output tile.
pack_outputs compresses the output tiles about ib times with the batched
RLWE packer (Chen et al. 2020), moving the payload offset ib-1 to 0 with the
inherent shift 2n - (ib-1).

Objectives (ref: matmul.h:18): EncryptLeft (x encrypted, w plain),
EncryptRight (w encrypted, x plain), Crossed (both encrypted).

The wire format (ref: matmul.cu serialize_outputs / deserialize_outputs):
unpacked outputs travel as sparse terms (save_ciphertext(terms=), only the
coefficients that carry outputs), packed ones whole; the encoded weights as
plaintexts.  The bytes are the JAX package's.  matmul(mesh=) and
pack_outputs(mesh=) split the contraction and the packing tree over a
parallel.mesh.Mesh (Evaluator.multiply_plain_contract,
pack_rlwe_ciphertexts_batched).
"""

from __future__ import annotations

import enum

import numpy as np

from .cipher2d import Plain2d, Cipher2d
from ..core.encryptor import Encryptor
from ..core.decryptor import Decryptor
from ..core.evaluator import Evaluator
from ..core.keys import GaloisKeys
from ..utils import serialize as S


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)


class MatmulObjective(enum.IntEnum):
    EncryptLeft = 0
    EncryptRight = 1
    Crossed = 2


class MatmulHelper:
    def __init__(self, batch_size: int, input_dims: int, output_dims: int,
                 slot_count: int,
                 objective: MatmulObjective = MatmulObjective.EncryptLeft,
                 pack_lwe: bool = True):
        self.batch_size = batch_size
        self.input_dims = input_dims
        self.output_dims = output_dims
        self.slot_count = slot_count
        self.objective = MatmulObjective(objective)
        self.pack_lwe = pack_lwe
        self.batch_block = 0
        self.input_block = 0
        self.output_block = 0
        self._determine_block()

    # ------------------------------------------------------------------
    def _determine_block(self):
        """Cost-model search over block sizes (ref: matmul.cu:101-161; with
        pack_lwe the input block is pinned near slot_count^(1/3))."""
        b_best = i_best = o_best = 0
        c_best = 1 << 62
        B, I, O, n = self.batch_size, self.input_dims, self.output_dims, self.slot_count
        obj = self.objective
        if not self.pack_lwe:
            for b in range(B, 0, -1):
                bc = ceil_div(B, b)
                if b >= n or bc * 2 > c_best:
                    continue
                for i in range(1, n // b):
                    o = min(n // b // i, O)
                    if i > I or o < 1:
                        continue
                    if obj == MatmulObjective.EncryptLeft:
                        c = bc * (ceil_div(I, i) + ceil_div(O, o))
                    elif obj == MatmulObjective.EncryptRight:
                        c = (bc + ceil_div(I, i)) * ceil_div(O, o)
                    else:
                        c = bc * I + (bc + ceil_div(I, i)) * ceil_div(O, o)
                    if c < c_best:
                        b_best, i_best, o_best, c_best = b, i, o, c
        else:
            sqrtn = n ** 0.33
            i = 1
            while i * 2 < sqrtn:
                i *= 2
            if i > I:
                i = 1
                while i < I:
                    i *= 2
            for b in range(1, B + 1):
                bc = ceil_div(B, b)
                if b > n:
                    continue
                o = min(n // b // i, O)
                if o < 1:
                    continue
                if obj == MatmulObjective.EncryptLeft:
                    c = bc * ceil_div(I, i) + ceil_div(bc * ceil_div(O, o), i)
                elif obj == MatmulObjective.EncryptRight:
                    c = ceil_div(O, o) * ceil_div(I, i) + ceil_div(bc * ceil_div(O, o), i)
                else:
                    c = (bc * ceil_div(I, i) + ceil_div(O, o) * ceil_div(I, i)
                         + ceil_div(bc * ceil_div(O, o), i))
                if c < c_best:
                    b_best, i_best, o_best, c_best = b, i, o, c
        if b_best == 0:
            raise ValueError("[MatmulHelper] no valid block decomposition")
        self.batch_block, self.input_block, self.output_block = b_best, i_best, o_best

    def _counts(self) -> tuple[int, int, int]:
        """Blocks along the batch, input and output dimensions."""
        return (ceil_div(self.batch_size, self.batch_block),
                ceil_div(self.input_dims, self.input_block),
                ceil_div(self.output_dims, self.output_block))

    # ------------------------------------------------------------------
    # encoding (ref: matmul.cu encode_weights / encode_inputs)
    # ------------------------------------------------------------------
    def _weight_vec(self, w: np.ndarray, lj: int, lk: int) -> np.ndarray:
        """The weight polynomial of the block at input row lj, output column lk."""
        ib, ob = self.input_block, self.output_block
        vec = np.zeros(ib * ob, dtype=w.dtype)
        for k in range(lk, min(lk + ob, self.output_dims)):
            for j in range(lj, min(lj + ib, self.input_dims)):
                vec[(k - lk) * ib + ib - 1 - (j - lj)] = w[j, k]
        return vec

    def _encode_weights(self, weights, encode) -> Plain2d:
        w = np.asarray(weights)
        return Plain2d([[encode(self._weight_vec(w, lj, lk))
                         for lk in range(0, self.output_dims, self.output_block)]
                        for lj in range(0, self.input_dims, self.input_block)])

    def encode_weights(self, adapter, weights) -> Plain2d:
        """weights: (input_dims, output_dims) array -> Plain2d of blocks."""
        return self._encode_weights(weights, adapter.encode_for_plain)

    def encode_weights_for_cipher(self, adapter, weights) -> Plain2d:
        return self._encode_weights(weights, adapter.encode_for_cipher)

    def encode_inputs(self, adapter, inputs, for_cipher: bool = True) -> Plain2d:
        """inputs: (batch_size, input_dims) array -> Plain2d of blocks."""
        x = np.asarray(inputs)
        bb, ib, ob = self.batch_block, self.input_block, self.output_block
        encode = adapter.encode_for_cipher if for_cipher else adapter.encode_for_plain
        rows = []
        for li in range(0, self.batch_size, bb):
            ui = min(li + bb, self.batch_size)
            row = []
            for lj in range(0, self.input_dims, ib):
                uj = min(lj + ib, self.input_dims)
                vec = np.zeros(self.slot_count, dtype=x.dtype)
                for i in range(li, ui):
                    vec[(i - li) * ib * ob:(i - li) * ib * ob + uj - lj] = x[i, lj:uj]
                row.append(encode(vec))
            rows.append(row)
        return Plain2d(rows)

    def encrypt_inputs(self, encryptor: Encryptor, adapter, inputs) -> Cipher2d:
        return self.encode_inputs(adapter, inputs, True).encrypt_symmetric(encryptor)

    def encrypt_weights(self, encryptor: Encryptor, adapter, weights) -> Cipher2d:
        return self.encode_weights_for_cipher(adapter, weights).encrypt_symmetric(encryptor)

    # ------------------------------------------------------------------
    # multiplication (ref: matmul.cu matmul / matmul_cipher / matmul_reverse)
    # ------------------------------------------------------------------
    def matmul(self, evaluator: Evaluator, a: Cipher2d, w: Plain2d, mesh=None) -> Cipher2d:
        """The whole block contraction in one multiply_plain_contract: every
        input block goes to the NTT domain once."""
        bs, is_, os_ = self._counts()
        cts = [[a[b][i] for i in range(is_)] for b in range(bs)]
        pls = [[w[i][j] for j in range(os_)] for i in range(is_)]
        return Cipher2d(evaluator.multiply_plain_contract(cts, pls, mesh=mesh))

    def matmul_fly(self, evaluator: Evaluator, adapter, a: Cipher2d, weights) -> Cipher2d:
        """matmul encoding each weight block when it is used, so that one
        encoded block is held at a time (ref: matmul.cu matmul_fly)."""
        w = np.asarray(weights)
        bs, _, os_ = self._counts()
        ret = [[None] * os_ for _ in range(bs)]
        for i, lj in enumerate(range(0, self.input_dims, self.input_block)):
            for j, lk in enumerate(range(0, self.output_dims, self.output_block)):
                pt = adapter.encode_for_plain(self._weight_vec(w, lj, lk))
                for b in range(bs):
                    prod = evaluator.multiply_plain(a[b][i], pt)
                    ret[b][j] = prod if ret[b][j] is None else evaluator.add(ret[b][j], prod)
        return Cipher2d(ret)

    def matmul_reverse(self, evaluator: Evaluator, a: Plain2d, w: Cipher2d) -> Cipher2d:
        """Plain inputs times encrypted weights through the same contraction
        with the roles transposed: out[b][j] = sum_i w[i][j] a[b][i]."""
        bs, is_, os_ = self._counts()
        cts = [[w[i][j] for i in range(is_)] for j in range(os_)]
        pls = [[a[b][i] for b in range(bs)] for i in range(is_)]
        out = evaluator.multiply_plain_contract(cts, pls)  # (os_, bs)
        return Cipher2d([[out[j][b] for j in range(os_)] for b in range(bs)])

    def matmul_cipher(self, evaluator: Evaluator, a: Cipher2d, w: Cipher2d) -> Cipher2d:
        bs, is_, os_ = self._counts()
        ret = [[None] * os_ for _ in range(bs)]
        for b in range(bs):
            for i in range(is_):
                for j in range(os_):
                    prod = evaluator.multiply(a[b][i], w[i][j])
                    ret[b][j] = prod if ret[b][j] is None else evaluator.add(ret[b][j], prod)
        return Cipher2d(ret)

    # ------------------------------------------------------------------
    # outputs (ref: matmul.cu encode_outputs / decrypt_outputs / pack_outputs)
    # ------------------------------------------------------------------
    def _out_pos(self, i, j, li, lj):
        ib, ob = self.input_block, self.output_block
        return (i - li) * ib * ob + (j - lj) * ib + ib - 1

    def _packed_slots(self):
        """With pack_lwe: (i, j, packed ciphertext, coefficient) of every
        output (i, j); output tile cid lands in ciphertext cid // ib at
        offset cid % ib."""
        bb, ob, ib = self.batch_block, self.output_block, self.input_block
        obc = ceil_div(self.output_dims, ob)
        for di, li in enumerate(range(0, self.batch_size, bb)):
            for dj, lj in enumerate(range(0, self.output_dims, ob)):
                pid, off = divmod(di * obc + dj, ib)
                for i in range(li, min(li + bb, self.batch_size)):
                    for j in range(lj, min(lj + ob, self.output_dims)):
                        yield i, j, pid, (i - li) * ib * ob + (j - lj) * ib + off

    def _tile_slots(self):
        """Without pack_lwe: (i, j, di, dj, coefficient) of every output."""
        bb, ob = self.batch_block, self.output_block
        for di, li in enumerate(range(0, self.batch_size, bb)):
            for dj, lj in enumerate(range(0, self.output_dims, ob)):
                for i in range(li, min(li + bb, self.batch_size)):
                    for j in range(lj, min(lj + ob, self.output_dims)):
                        yield i, j, di, dj, self._out_pos(i, j, li, lj)

    def encode_outputs(self, adapter, outputs) -> Plain2d:
        """A plain bias or output matrix in the product layout (the packed
        layout with pack_lwe)."""
        y = np.asarray(outputs)
        bs, _, os_ = self._counts()
        if not self.pack_lwe:
            bufs = [[np.zeros(self.slot_count, dtype=y.dtype) for _ in range(os_)]
                    for _ in range(bs)]
            for i, j, di, dj, pos in self._tile_slots():
                bufs[di][dj][pos] = y[i, j]
            return Plain2d([[adapter.encode_for_cipher(v) for v in row] for row in bufs])
        bufs = [np.zeros(self.slot_count, dtype=y.dtype)
                for _ in range(ceil_div(bs * os_, self.input_block))]
        for i, j, pid, pos in self._packed_slots():
            bufs[pid][pos] = y[i, j]
        return Plain2d([[adapter.encode_for_cipher(b) for b in bufs]])

    def pack_outputs(self, evaluator: Evaluator, auto_keys: GaloisKeys,
                     cipher: Cipher2d, mesh=None) -> Cipher2d:
        """Compress the output tiles about input_block times: groups of
        input_block tiles through pack_rlwe_ciphertexts_batched, the payload
        offset ib-1 moved to 0 by the inherent shift 2n - (ib-1)
        (ref: matmul.cu pack_outputs)."""
        if not self.pack_lwe:
            raise ValueError("[MatmulHelper.pack_outputs] pack_lwe disabled")
        ib = self.input_block
        inherent_shift = 0 if ib == 1 else 2 * self.slot_count - (ib - 1)
        flat = [c for row in cipher.data for c in row]
        groups = [flat[i:i + ib] for i in range(0, len(flat), ib)]
        return Cipher2d([evaluator.pack_rlwe_ciphertexts_batched(
            groups, auto_keys, inherent_shift, ib, 1, mesh=mesh)])

    def _required_terms(self) -> list[list[int]]:
        """Per (di, dj) block: the coefficient indices that carry outputs."""
        bb, ob = self.batch_block, self.output_block
        return [[self._out_pos(i, j, li, lj)
                 for i in range(li, min(li + bb, self.batch_size))
                 for j in range(lj, min(lj + ob, self.output_dims))]
                for li in range(0, self.batch_size, bb)
                for lj in range(0, self.output_dims, ob)]

    def serialize_outputs(self, context, outputs: Cipher2d, mode=None) -> list[bytes]:
        """One frame per output ciphertext: whole when packed, else the terms
        of its block."""
        mode = S.CompressionMode.Nil if mode is None else mode
        if self.pack_lwe:
            return [S.save_ciphertext(c, context, mode) for c in outputs[0]]
        flat = [c for row in outputs.data for c in row]
        return [S.save_ciphertext(c, context, mode, terms=t)
                for c, t in zip(flat, self._required_terms())]

    def deserialize_outputs(self, context, blobs: list[bytes]) -> Cipher2d:
        cts = [S.load_ciphertext(b, context) for b in blobs]
        if self.pack_lwe:
            return Cipher2d([cts])
        obc = ceil_div(self.output_dims, self.output_block)
        return Cipher2d([cts[i:i + obc] for i in range(0, len(cts), obc)])

    def serialize_encoded_weights(self, w: Plain2d, mode=None) -> list[bytes]:
        mode = S.CompressionMode.Nil if mode is None else mode
        return [S.save_plaintext(p, mode) for row in w.data for p in row]

    def deserialize_encoded_weights(self, blobs: list[bytes], device) -> Plain2d:
        """device: a HeContext or a device, where the plaintexts land."""
        pts = [S.load_plaintext(b, device) for b in blobs]
        ibc = ceil_div(self.input_dims, self.input_block)
        obc = ceil_div(self.output_dims, self.output_block)
        if len(pts) != ibc * obc:
            raise ValueError(f"[MatmulHelper.deserialize_encoded_weights] {len(pts)} "
                             f"plaintexts, expected {ibc * obc}")
        return Plain2d([pts[i:i + obc] for i in range(0, len(pts), obc)])

    def decrypt_outputs(self, adapter, decryptor: Decryptor, outputs: Cipher2d) -> np.ndarray:
        cache: dict = {}

        def buf(key, ct):
            if key not in cache:
                cache[key] = adapter.decrypt_outputs(decryptor, ct)
            return cache[key]

        first = buf((0, 0), outputs[0][0])
        dec = np.zeros((self.batch_size, self.output_dims), dtype=np.asarray(first).dtype)
        if not self.pack_lwe:
            for i, j, di, dj, pos in self._tile_slots():
                dec[i, j] = buf((di, dj), outputs[di][dj])[pos]
            return dec
        for i, j, pid, pos in self._packed_slots():
            dec[i, j] = buf((0, pid), outputs[0][pid])[pos]
        return dec
