"""Modulus-switching chain: ContextData + HeContext, with tables on a device.

Counterpart of troy_tpu/core/context.py, for BFV and CKKS.  Each
ContextData bundles one level's tables (NTT tables, the RNS tool: the BFV
toolbox, or for CKKS only the division by the last prime; the BFV scaler),
built on the host with Python ints on first use and moved to the context's
device.  The
chain runs key level -> first -> ... -> last, each level dropping the
trailing prime; the last prime of the key level is the special prime.

The port covers the u32 fast width only (29/30-bit primes).
"""

from __future__ import annotations

import torch

from .params import EncryptionParameters, ParmsID, SchemeType
from .coeff_modulus import CoeffModulus, SecurityLevel
from ..ops.ntt import NTTTables
from ..rns.rns_base import RNSBase
from ..rns.rns_tool import LastPrimeTool, RNSTool
from ..rns.scaling import BFVScaler


class ContextData:
    """Per-level bundle of parameters and device tables."""

    def __init__(self, parms: EncryptionParameters, device, chain_index: int = 0):
        self.parms = parms
        self.device = torch.device(device)
        self.chain_index = chain_index  # 0 at the key level, growing down the chain
        self.prev: ContextData | None = None   # towards key level (more primes)
        self.next: ContextData | None = None   # towards last level (fewer primes)
        n = parms.poly_modulus_degree
        self.log_n = n.bit_length() - 1
        moduli = parms.coeff_modulus
        for m in moduli:
            if not m.is_prime:
                raise ValueError(f"[ContextData] coeff modulus {m.value} not prime")
            if not m.fits_fast_path():
                raise ValueError(
                    f"[ContextData] coeff modulus {m.value} outside the u32 "
                    "fast-path range (2^28, 2^30); the port has no wide path yet")
            if m.value % (2 * n) != 1:
                raise ValueError(f"[ContextData] modulus {m.value} is not NTT-friendly")
        t = parms.plain_modulus
        if t.value and any(m.value == t.value for m in moduli):
            raise ValueError("[ContextData] plain modulus equals a coeff modulus")
        self.base_q = RNSBase(moduli, self.device)
        self.total_coeff_modulus: int = self.base_q.prod
        self.simd_supported = bool(t.value and t.is_prime and t.value % (2 * n) == 1)
        self._ntt_tables: NTTTables | None = None
        self._rns_tool: LastPrimeTool | None = None
        self._scaler: BFVScaler | None = None

    @property
    def ntt_tables(self) -> NTTTables:
        if self._ntt_tables is None:
            self._ntt_tables = NTTTables(self.log_n, self.parms.coeff_modulus,
                                         self.device)
        return self._ntt_tables

    @property
    def rns_tool(self) -> LastPrimeTool:
        """RNSTool for BFV; for CKKS (no plain modulus) the last-prime
        division alone."""
        if self._rns_tool is None:
            if self.parms.scheme == SchemeType.BFV:
                self._rns_tool = RNSTool(self.log_n, self.base_q, self.parms.plain_modulus)
            else:
                self._rns_tool = LastPrimeTool(self.log_n, self.base_q)
        return self._rns_tool

    @property
    def scaler(self) -> BFVScaler:
        if self._scaler is None:
            self._scaler = BFVScaler(self.base_q, self.parms.plain_modulus)
        return self._scaler

    @property
    def parms_id(self) -> ParmsID:
        return self.parms.parms_id

    @property
    def coeff_modulus_size(self) -> int:
        return len(self.parms.coeff_modulus)

    def qtab(self) -> NTTTables:
        """NTT tables of base q at this level."""
        return self.ntt_tables

    def is_last(self) -> bool:
        return self.next is None


class HeContext:
    """Chain of ContextData keyed by ParmsID.  The last modulus of
    parms.coeff_modulus is the special prime, used at the key level for
    keyswitching; the first (data) level drops it."""

    def __init__(self):
        self._data: dict[ParmsID, ContextData] = {}
        self.key_parms_id: ParmsID = ""
        self.first_parms_id: ParmsID = ""
        self.last_parms_id: ParmsID = ""
        self.using_keyswitching = False
        self.seed: int | None = None

    @staticmethod
    def create(parms: EncryptionParameters, device,
               sec_level: SecurityLevel = SecurityLevel.Classical128,
               seed: int | None = None) -> "HeContext":
        """The chain for parms on device.  seed keys the default samplers of
        the objects made from the context (utils/random.py:stream), as in
        the JAX package's HeContext.create(..., seed)."""
        if parms.scheme not in (SchemeType.BFV, SchemeType.CKKS):
            raise ValueError("[HeContext.create] the port supports BFV and CKKS")
        ctx = HeContext()
        ctx.seed = seed
        n = parms.poly_modulus_degree
        total_bits = sum(m.bit_count for m in parms.coeff_modulus)
        if sec_level != SecurityLevel.Nil and \
                total_bits > CoeffModulus.max_bit_count(n, sec_level):
            raise ValueError(
                f"[HeContext.create] log q = {total_bits} exceeds the "
                f"{int(sec_level)}-bit security bound for n={n}")
        key_data = ContextData(parms.clone(), device)
        chain = [key_data]
        if len(parms.coeff_modulus) > 1:
            ctx.using_keyswitching = True
            cur = key_data
            while len(cur.parms.coeff_modulus) > 1:
                nxt = ContextData(cur.parms.clone().set_coeff_modulus(
                    cur.parms.coeff_modulus[:-1]), device, cur.chain_index + 1)
                nxt.prev, cur.next = cur, nxt
                chain.append(nxt)
                cur = nxt
        for cd in chain:
            ctx._data[cd.parms_id] = cd
        ctx.key_parms_id = key_data.parms_id
        ctx.first_parms_id = chain[1].parms_id if len(chain) > 1 else key_data.parms_id
        ctx.last_parms_id = chain[-1].parms_id
        return ctx

    def get_context_data(self, parms_id: ParmsID) -> ContextData:
        if parms_id not in self._data:
            raise KeyError(f"[HeContext] unknown parms_id {parms_id[:16]}...")
        return self._data[parms_id]

    def key_context_data(self) -> ContextData:
        return self._data[self.key_parms_id]

    def first_context_data(self) -> ContextData:
        return self._data[self.first_parms_id]

    def last_context_data(self) -> ContextData:
        return self._data[self.last_parms_id]

    @property
    def scheme(self) -> SchemeType:
        return self.key_context_data().parms.scheme
