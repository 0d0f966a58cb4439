"""Modulus-switching chain: ContextData + HeContext, with tables on a device.

Counterpart of troy_tpu/core/context.py, for BFV, CKKS and BGV.  Each
ContextData bundles one level's tables (NTT tables, the RNS tool: the BFV
and BGV toolbox, or for CKKS only the division by the last prime; the
scaler, whose centred lift BGV uses too),
built on the host with Python ints on first use and moved to the context's
device.  The
chain runs key level -> first -> ... -> last, each level dropping the
trailing prime; the last prime of the key level is the special prime.

Two residue widths, as in the JAX package: every prime on the fast path
(2^28, 2^30), or every prime on the wide path (2^30, 2^61), the SEAL-default
40-60-bit sets.  A wide level sets `wide` and builds the wide tables
(ops/ntt64.NTT64Tables, rns/rns_tool64.RNSTool64, rns/scaling.BFVScaler64);
both widths hold one int64 word per residue in the same layout, and ops/rp.py
dispatches on the tables' `words`.
"""

from __future__ import annotations

from dataclasses import dataclass, replace as _dc_replace

import torch

from .params import EncryptionParameters, ParmsID, SchemeType, WIDE_PARMS_IDS
from .coeff_modulus import CoeffModulus, SecurityLevel
from ..ops.ntt import NTTTables
from ..ops.ntt64 import NTT64Tables
from ..rns.rns_base import RNSBase
from ..rns.rns_tool import LastPrimeTool, RNSTool
from ..rns.rns_tool64 import RNSTool64
from ..rns.scaling import BFVScaler, BFVScaler64


@dataclass(frozen=True)
class EncryptionParameterQualifiers:
    """Feature flags for a validated parameter set (ref:
    encryption_parameters.h:277).  parameter_error is always "Success" on a
    constructed context: invalid parameters raise instead."""

    parameter_error: str = "Success"
    using_fft: bool = True
    using_ntt: bool = True
    using_batching: bool = False
    using_fast_plain_lift: bool = False
    using_descending_modulus_chain: bool = False
    security_level: SecurityLevel = SecurityLevel.Nil

    def parameters_set(self) -> bool:
        return self.parameter_error == "Success"


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
        # residue width: all primes on the fast path, or all on the wide path
        self.wide = any(not m.fits_fast_path() for m in moduli)
        for m in moduli:
            if not m.is_prime:
                raise ValueError(f"[ContextData] coeff modulus {m.value} not prime")
            if self.wide:
                if not m.fits_wide_path():
                    raise ValueError(
                        f"[ContextData] coeff modulus {m.value} outside the "
                        "wide-path range (2^30, 2^61) — widths cannot mix")
            elif not m.fits_fast_path():
                raise ValueError(
                    f"[ContextData] coeff modulus {m.value} outside the u32 "
                    "fast-path range [2^28, 2^30)")
            if m.value % (2 * n) != 1:
                raise ValueError(f"[ContextData] modulus {m.value} is not NTT-friendly")
        if self.wide and parms.plain_modulus.value >= (1 << 31):
            raise ValueError(
                "[ContextData] plain modulus must be < 2^31 (use ring2k for "
                "wider plaintext moduli)")
        t = parms.plain_modulus
        if t.value and parms.scheme in (SchemeType.BFV, SchemeType.BGV) \
                and any(m.value == t.value for m in moduli):
            raise ValueError("[ContextData] plain modulus equals a coeff modulus")
        if self.wide:
            WIDE_PARMS_IDS.add(parms.parms_id)
        self.base_q = RNSBase(moduli, self.device)
        self.total_coeff_modulus: int = self.base_q.prod
        self.simd_supported = bool(t.value and t.is_prime and t.value % (2 * n) == 1)
        self.qualifiers = EncryptionParameterQualifiers(
            using_batching=(self.simd_supported or parms.scheme == SchemeType.CKKS),
            using_fast_plain_lift=bool(t.value and all(m.value > t.value for m in moduli)),
            using_descending_modulus_chain=all(
                moduli[i].value > moduli[i + 1].value for i in range(len(moduli) - 1)))
        self._ntt_tables: NTTTables | None = None
        self._rns_tool: LastPrimeTool | None = None
        self._scaler: BFVScaler | None = None

    @property
    def ntt_tables(self) -> NTTTables:
        if self._ntt_tables is None:
            if self.wide:
                self._ntt_tables = NTT64Tables(self.log_n, self.parms.coeff_modulus,
                                               self.device)
            else:
                self._ntt_tables = NTTTables(self.log_n, self.parms.coeff_modulus,
                                             self.device)
        return self._ntt_tables

    @property
    def rns_tool(self) -> LastPrimeTool:
        """RNSTool (with t) for BFV and BGV; for CKKS (no plain modulus)
        the last-prime division alone."""
        if self._rns_tool is None and self.wide:
            t = self.parms.plain_modulus
            self._rns_tool = RNSTool64(
                self.log_n, self.base_q,
                t if (t.value and self.parms.scheme != SchemeType.CKKS) else None)
        elif self._rns_tool is None:
            if self.parms.scheme != SchemeType.CKKS and self.parms.plain_modulus.value:
                self._rns_tool = RNSTool(self.log_n, self.base_q, self.parms.plain_modulus)
            else:
                self._rns_tool = LastPrimeTool(self.log_n, self.base_q)
        return self._rns_tool

    @property
    def scaler(self) -> BFVScaler:
        if self._scaler is None:
            if self.wide:
                self._scaler = BFVScaler64(self.base_q, self.parms.plain_modulus)
            else:
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
        self.security_level = SecurityLevel.Nil

    @staticmethod
    def create(parms: EncryptionParameters, expand_mod_chain: bool = True,
               sec_level: SecurityLevel = SecurityLevel.Classical128,
               seed: int | None = None, *, device=None) -> "HeContext":
        """The chain for parms, as the JAX package's HeContext.create: the key
        level, the first data level (the special prime dropped) and, when
        expand_mod_chain, every level below it down to one prime.  seed keys
        the default samplers of the objects made from the context
        (utils/random.py:stream).  device is where the tables live: the CUDA
        card when None (RuntimeError without one), else any torch device."""
        if isinstance(expand_mod_chain, (str, torch.device)):
            raise TypeError(
                "[HeContext.create] the second argument is expand_mod_chain (a "
                f"bool), got the device {expand_mod_chain!r}: pass it as device=")
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError("[HeContext.create] no CUDA device: pass device= "
                                   "(e.g. device=\"cpu\") to build the context elsewhere")
            device = torch.device("cuda")
        ctx = HeContext()
        ctx.seed = seed
        ctx.security_level = sec_level
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
            # the first data level always, the levels below it when expanding
            while len(cur.parms.coeff_modulus) > 1 and (expand_mod_chain or len(chain) < 2):
                nxt = ContextData(cur.parms.clone().set_coeff_modulus(
                    cur.parms.coeff_modulus[:-1]), device, cur.chain_index + 1)
                nxt.prev, cur.next = cur, nxt
                chain.append(nxt)
                cur = nxt
        for cd in chain:
            cd.qualifiers = _dc_replace(cd.qualifiers, security_level=sec_level)
            ctx._data[cd.parms_id] = cd
        ctx.key_parms_id = key_data.parms_id
        ctx.first_parms_id = chain[1].parms_id if len(chain) > 1 else key_data.parms_id
        ctx.last_parms_id = chain[-1].parms_id
        return ctx

    def parameters_set(self) -> bool:
        """True when the context's parameters validated (ref: he_context.h:97):
        always on a constructed context, since create() raises instead."""
        return self.first_context_data().qualifiers.parameters_set()

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
