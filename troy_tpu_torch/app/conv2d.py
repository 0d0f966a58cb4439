"""Cheetah-style ciphertext-plaintext 2D convolution (counterpart of
troy_tpu/app/conv2d.py): the valid (unpadded) convolution
y[b, oc] = sum_ic x[b, ic] * k[oc, ic] as negacyclic polynomial products,
with blocks over batch, channels and overlapping image tiles (tile step =
block - kernel + 1), in the reference's layout:

  block_size = h_blk * w_blk
  input  [eb][icg]: vec[b*(ci*co*bs) + tci*bs + ti*w_blk + tj] = x[...]
  weight [ocg][icg]: vec[(oc)*(ci*bs) + (ci-1-tic)*bs + ki*w_blk + kj]
                      = k[oc, ic, kh-1-ki, kw-1-kj]      (flipped kernel)
  output pixel (i, j) of tile: coeff[(b*ci*co + oc*ci + ci-1)*bs
                      + (kh-1+i)*w_blk + (kw-1+j)]

The wire format (ref: conv2d.h:113-114, conv2d.cu:719-803) ships only the
coefficients that carry output pixels (sparse save_terms), as MatmulHelper
does.  conv2d(mesh=) splits the contraction over a parallel.mesh.Mesh
(Evaluator.multiply_plain_contract).
"""

from __future__ import annotations

import numpy as np

from .cipher2d import Plain2d, Cipher2d
from .matmul import MatmulObjective, ceil_div
from ..core.encryptor import Encryptor
from ..core.decryptor import Decryptor
from ..core.evaluator import Evaluator
from ..utils import serialize as S


class Conv2dHelper:
    def __init__(self, batch_size: int, input_channels: int, output_channels: int,
                 image_height: int, image_width: int,
                 kernel_height: int, kernel_width: int, slot_count: int,
                 objective: MatmulObjective = MatmulObjective.EncryptLeft):
        self.batch_size = batch_size
        self.input_channels = input_channels
        self.output_channels = output_channels
        self.image_height = image_height
        self.image_width = image_width
        self.kernel_height = kernel_height
        self.kernel_width = kernel_width
        self.slot_count = slot_count
        self.objective = MatmulObjective(objective)
        self._determine_block()

    # ------------------------------------------------------------------
    def _determine_block(self):
        """Exhaustive cost search (ref: conv2d.cu:31 determine_block)."""
        best = 1 << 62
        B, Ci, Co = self.batch_size, self.input_channels, self.output_channels
        H, W, kh, kw = (self.image_height, self.image_width,
                        self.kernel_height, self.kernel_width)
        n = self.slot_count
        found = None
        for b in range(B, 0, -1):
            for h in range(min(H, n // b), kh - 1, -1):
                for w in range(min(W, n // b // h), kw - 1, -1):
                    for co in range(min(Co, n // b // h // w), 0, -1):
                        ci = min(n // b // h // w // co, Ci)
                        if ci == 0:
                            continue
                        tiles = (ceil_div(B, b)
                                 * ceil_div(H - kh + 1, h - kh + 1)
                                 * ceil_div(W - kw + 1, w - kw + 1))
                        in_sz = tiles * ceil_div(Ci, ci)
                        out_sz = tiles * ceil_div(Co, co)
                        w_sz = ceil_div(Ci, ci) * ceil_div(Co, co)
                        if self.objective == MatmulObjective.EncryptLeft:
                            cur = in_sz + out_sz
                        elif self.objective == MatmulObjective.EncryptRight:
                            cur = w_sz + out_sz
                        else:
                            cur = in_sz + out_sz + w_sz
                        if cur < best:
                            best = cur
                            found = (b, h, w, ci, co)
        if found is None:
            raise ValueError("[Conv2dHelper] image/kernel does not fit slot count")
        (self.batch_block, self.image_height_block, self.image_width_block,
         self.input_channel_block, self.output_channel_block) = found

    def _tile_counts(self) -> tuple[int, int]:
        kh, kw = self.kernel_height - 1, self.kernel_width - 1
        sh = ceil_div(self.image_height - kh, self.image_height_block - kh)
        sw = ceil_div(self.image_width - kw, self.image_width_block - kw)
        return sh, sw

    def get_total_batch_size(self) -> int:
        sh, sw = self._tile_counts()
        return ceil_div(self.batch_size, self.batch_block) * sh * sw

    def _groups(self) -> tuple[int, int, int]:
        """Batch tiles, output channel groups, input channel groups."""
        return (self.get_total_batch_size(),
                ceil_div(self.output_channels, self.output_channel_block),
                ceil_div(self.input_channels, self.input_channel_block))

    # ------------------------------------------------------------------
    def encode_weights(self, adapter, weights, for_cipher: bool = False) -> Plain2d:
        """weights: (out_channels, in_channels, kh, kw), flipped into each
        (output group, input group) block."""
        k = np.asarray(weights)
        kh, kw = self.kernel_height, self.kernel_width
        bs = self.image_height_block * self.image_width_block
        ci_b, co_b = self.input_channel_block, self.output_channel_block
        encode = adapter.encode_for_cipher if for_cipher else adapter.encode_for_plain
        flipped = k[:, :, ::-1, ::-1]
        rows = []
        for loc in range(0, self.output_channels, co_b):
            row = []
            for lic in range(0, self.input_channels, ci_b):
                vec = np.zeros(ci_b * co_b * bs, dtype=k.dtype)
                for oc in range(loc, min(loc + co_b, self.output_channels)):
                    for ic in range(lic, min(lic + ci_b, self.input_channels)):
                        base = (oc - loc) * ci_b * bs + (ci_b - 1 - (ic - lic)) * bs
                        for ki in range(kh):
                            at = base + ki * self.image_width_block
                            vec[at:at + kw] = flipped[oc, ic, ki]
                row.append(encode(vec))
            rows.append(row)
        return Plain2d(rows)

    def encode_inputs(self, adapter, inputs, for_cipher: bool = True) -> Plain2d:
        """inputs: (batch, in_channels, H, W), cut into overlapping tiles."""
        x = np.asarray(inputs)
        kh, kw = self.kernel_height - 1, self.kernel_width - 1
        sh, sw = self._tile_counts()
        hb, wb = self.image_height_block, self.image_width_block
        bs = hb * wb
        ci_b, co_b = self.input_channel_block, self.output_channel_block
        encode = adapter.encode_for_cipher if for_cipher else adapter.encode_for_plain
        rows = []
        for lb in range(0, self.batch_size, self.batch_block):
            ub = min(lb + self.batch_block, self.batch_size)
            for ih in range(sh):
                for iw in range(sw):
                    si, sj = ih * (hb - kh), iw * (wb - kw)
                    ui, uj = min(si + hb, self.image_height), min(sj + wb, self.image_width)
                    group = []
                    for lci in range(0, self.input_channels, ci_b):
                        uci = min(lci + ci_b, self.input_channels)
                        vec = np.zeros(self.slot_count, dtype=x.dtype)
                        for b in range(ub - lb):
                            for tci in range(uci - lci):
                                for ti in range(si, ui):
                                    at = b * ci_b * co_b * bs + tci * bs + (ti - si) * wb
                                    vec[at:at + uj - sj] = x[lb + b, lci + tci, ti, sj:uj]
                        group.append(encode(vec))
                    rows.append(group)
        return Plain2d(rows)

    def encrypt_inputs(self, encryptor: Encryptor, adapter, inputs) -> Cipher2d:
        return self.encode_inputs(adapter, inputs, True).encrypt_symmetric(encryptor)

    def encrypt_weights(self, encryptor: Encryptor, adapter, weights) -> Cipher2d:
        return self.encode_weights(adapter, weights, True).encrypt_symmetric(encryptor)

    # ------------------------------------------------------------------
    def conv2d(self, evaluator: Evaluator, a: Cipher2d, w: Plain2d, mesh=None) -> Cipher2d:
        """The whole channel contraction in one multiply_plain_contract
        (ref: conv2d.cu:356)."""
        total, ocg, icg = self._groups()
        cts = [[a[eb][i] for i in range(icg)] for eb in range(total)]
        pls = [[w[j][i] for j in range(ocg)] for i in range(icg)]
        return Cipher2d(evaluator.multiply_plain_contract(cts, pls, mesh=mesh))

    def _accumulate(self, evaluator: Evaluator, product) -> Cipher2d:
        """ret[eb][j] = sum_i product(eb, j, i)."""
        total, ocg, icg = self._groups()
        ret = []
        for eb in range(total):
            row = []
            for j in range(ocg):
                acc = None
                for i in range(icg):
                    prod = product(eb, j, i)
                    acc = prod if acc is None else evaluator.add(acc, prod)
                row.append(acc)
            ret.append(row)
        return Cipher2d(ret)

    def conv2d_reverse(self, evaluator: Evaluator, a: Plain2d, w: Cipher2d) -> Cipher2d:
        return self._accumulate(evaluator, lambda eb, j, i: evaluator.multiply_plain(
            w[j][i], a[eb][i]))

    def conv2d_cipher(self, evaluator: Evaluator, a: Cipher2d, w: Cipher2d) -> Cipher2d:
        return self._accumulate(evaluator, lambda eb, j, i: evaluator.multiply(
            a[eb][i], w[j][i]))

    # ------------------------------------------------------------------
    def _positions(self):
        """Yields (eb, output group, coefficient index, (b, c, oi, oj)) for
        every output pixel."""
        bs = self.image_height_block * self.image_width_block
        ci_b, co_b = self.input_channel_block, self.output_channel_block
        yh = self.image_height_block - self.kernel_height + 1
        yw = self.image_width_block - self.kernel_width + 1
        oyh = self.image_height - self.kernel_height + 1
        oyw = self.image_width - self.kernel_width + 1
        sh, sw = self._tile_counts()
        for eb in range(self.get_total_batch_size()):
            ob = eb // (sh * sw)
            si = (eb % (sh * sw)) // sw
            sj = eb % sw
            lb = ob * self.batch_block
            ub = min(lb + self.batch_block, self.batch_size)
            for lc in range(0, self.output_channels, co_b):
                uc = min(lc + co_b, self.output_channels)
                for b in range(lb, ub):
                    for c in range(lc, uc):
                        for i in range(yh):
                            for j in range(yw):
                                if si * yh + i >= oyh or sj * yw + j >= oyw:
                                    continue
                                mask_index = (
                                    ((b - lb) * ci_b * co_b + (c - lc) * ci_b + ci_b - 1) * bs
                                    + (self.image_height_block - yh + i) * self.image_width_block
                                    + (self.image_width_block - yw + j))
                                yield (eb, lc // co_b, mask_index,
                                       (b, c, si * yh + i, sj * yw + j))

    def encode_outputs(self, adapter, outputs) -> Plain2d:
        """outputs: (batch, out_channels, H-kh+1, W-kw+1), a bias matrix in
        the product layout."""
        y = np.asarray(outputs)
        total, ocg, _ = self._groups()
        bufs = [[np.zeros(self.slot_count, dtype=y.dtype) for _ in range(ocg)]
                for _ in range(total)]
        for eb, jg, mi, (b, c, oi, oj) in self._positions():
            bufs[eb][jg][mi] = y[b, c, oi, oj]
        return Plain2d([[adapter.encode_for_cipher(v) for v in row] for row in bufs])

    def _required_terms(self) -> list[list[list[int]]]:
        """terms[eb][ocg]: the sorted coefficient indices carrying outputs."""
        total, ocg, _ = self._groups()
        terms: list[list[list[int]]] = [[[] for _ in range(ocg)] for _ in range(total)]
        for eb, jg, mi, _ in self._positions():
            terms[eb][jg].append(mi)
        return [[sorted(cell) for cell in row] for row in terms]

    def serialize_outputs(self, context, outputs: Cipher2d, mode=None) -> list[bytes]:
        mode = S.CompressionMode.Nil if mode is None else mode
        terms = self._required_terms()
        return [S.save_ciphertext(c, context, mode, terms=terms[eb][jg])
                for eb, row in enumerate(outputs.data) for jg, c in enumerate(row)]

    def deserialize_outputs(self, context, blobs: list[bytes]) -> Cipher2d:
        cts = [S.load_ciphertext(b, context) for b in blobs]
        ocg = ceil_div(self.output_channels, self.output_channel_block)
        return Cipher2d([cts[i:i + ocg] for i in range(0, len(cts), ocg)])

    def decrypt_outputs(self, adapter, decryptor: Decryptor, outputs: Cipher2d) -> np.ndarray:
        oyh = self.image_height - self.kernel_height + 1
        oyw = self.image_width - self.kernel_width + 1
        cache = {(0, 0): adapter.decrypt_outputs(decryptor, outputs[0][0])}
        ret = np.zeros((self.batch_size, self.output_channels, oyh, oyw),
                       dtype=np.asarray(cache[(0, 0)]).dtype)
        for eb, jg, mi, (b, c, oi, oj) in self._positions():
            if (eb, jg) not in cache:
                cache[(eb, jg)] = adapter.decrypt_outputs(decryptor, outputs[eb][jg])
            ret[b, c, oi, oj] = cache[(eb, jg)][mi]
        return ret
