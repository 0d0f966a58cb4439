"""The explicit partition of the batched steps and the mesh= paths over a
Mesh (parallel/mesh.py): what GSPMD derives from shardings in the JAX
package, written out stage by stage.

A sharded input splits into groups: the mesh positions that share every
coordinate but the split axis of the tensor, the limb axis ('limb') or the
coefficient axis ('poly').  Positions that split only the batch ('data',
'host') are groups of one.  A group of one runs the unsharded stages on its
own batch rows with no collective; groups are independent, and a process
runs only the groups it holds.

'limb' (K shards, shard k holding q rows I_k, the first shards larger):
  * limb-local stages run on the shard's own rows with tables cut to them
    (NTTTables.take): the NTTs and the dyadic products of q, the contraction
    of multiply_plain_contract, the PackLWEs tree's additions, shifts and
    Galois gathers, the keyswitch's division;
  * the BFV multiply's Bsk side is split the same way, shard k holding the
    Bsk rows J_k: the lift q -> Bsk (an all-gather of the operand first, so
    every shard folds the float32 HPS alpha over all limbs in the unsharded
    order: float partial sums would round differently), its NTTs and
    products, the floor (an all-gather of the q-side product), and the SK
    conversion back to the shard's q rows (an all-gather of the floor);
  * the keyswitch all-gathers its target (the digit broadcast), computes
    the digits, their NTTs and the key inner product of its own output rows;
    the last shard also computes the special prime's row and broadcasts it
    after its inverse NTT; then each shard divides its own rows.
'poly' (K shards of columns): every stage but a transform is a function of
  each coefficient, so each shard runs the unsharded stages on its columns;
  each NTT is an all-to-all to shards of whole rows (the flattened batch x
  limb rows, each with its prime's tables), the transform, and the
  all-to-all back.
Both take the route of the level's tables: under set_ntt_backend("mxu") or
("pallas_mxu") a shard's rows go through the matrix-product kernel
(ops/ntt_mxu_cuda.py), its tables cut to the rows by NTTTables.take.

Every cross-shard copy is logged in the CollectiveRecord with the bytes the
receiving shards get (a fast-path residue crosses as a 32-bit word); every
shard stage counts as that shard's work with the kernel launches it made.
The plans take a shard's tensors on its own device, each device with its own
copy of the level's tables (an HeContext built there, cached).
"""

from __future__ import annotations

import numpy as np
import torch

from . import mesh as M
from ..core.ciphertext import Ciphertext
from ..core.evaluator import Evaluator
from ..core.lwe_ops import LweOpsMixin
from ..core.params import SchemeType
from ..ops import poly as P, rp as R
from ..ops.galois import GaloisTool
from ..utils.timer import launch_counts


# ---------------------------------------------------------------------------
# devices and per-shard tables
# ---------------------------------------------------------------------------

def _norm(dev) -> torch.device:
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def context_on(ctx, dev):
    """ctx's twin with its tables on dev (ctx itself where they live there):
    an HeContext built on dev from the same parameters, cached."""
    dev = _norm(dev)
    if dev == _norm(ctx.key_context_data().device):
        return ctx
    twins = ctx.__dict__.setdefault("_device_twins", {})
    if dev not in twins:
        twins[dev] = type(ctx).create(ctx.key_context_data().parms, len(ctx._data) > 2,
                                      ctx.security_level, ctx.seed, device=dev)
    return twins[dev]


def on_device(ev, cd, dev):
    """(evaluator, level) with their tables on dev (context_on)."""
    ctx_d = context_on(ev.context, dev)
    if ctx_d is ev.context:
        return ev, cd
    twins = ev.__dict__.setdefault("_device_twins", {})
    dev = _norm(dev)
    if dev not in twins:
        twins[dev] = type(ev)(ctx_d, lift=ev.lift)
    return twins[dev], ctx_d.get_context_data(cd.parms_id)


def _limb_part(ev, cd, K: int, k: int, dev) -> dict:
    """Shard k of K's rows and tables at a level: q rows I (None: every row),
    their NTT tables, the BFV Bsk rows J and tables, and the keyswitch
    tables of rows I (with the special prime's row on the last shard)."""
    ev_d, cd_d = on_device(ev, cd, dev)
    cache = cd_d.__dict__.setdefault("_limb_parts", {})
    if (K, k) not in cache:
        L = cd_d.coeff_modulus_size
        lo, hi = M.split(L, K)[k]
        rows = None if K == 1 else tuple(range(lo, hi))
        part = dict(I=rows, qtab=cd_d.qtab() if rows is None else cd_d.qtab().take(list(rows)))
        if cd_d.parms.scheme == SchemeType.BFV and cd_d.parms.plain_modulus.value:
            tool = cd_d.rns_tool
            blo, bhi = M.split(tool.base_Bsk.size, K)[k]
            J = None if K == 1 else tuple(range(blo, bhi))
            part.update(J=J, btab=tool.bsk_ntt if J is None else tool.bsk_ntt.take(list(J)))
        if ev_d.context.using_keyswitching:
            part["sw"] = ev_d._switch_rows(cd_d, rows, k == K - 1)
        cache[K, k] = part
    return dict(cache[K, k], ev=ev_d, cd=cd_d)


# ---------------------------------------------------------------------------
# a group of shards
# ---------------------------------------------------------------------------

class Group:
    """K shards (flat mesh positions `flat`, in split order) of one tensor
    axis; recs: the records its copies and stages go to; wire: bytes a
    residue takes on the wire."""

    def __init__(self, mesh: M.Mesh, flat: list[int], recs: list, wire: int):
        self.mesh, self.flat, self.recs, self.wire = mesh, flat, recs, wire
        self.K = len(flat)
        self.devs = [_norm(mesh.devices.flat[i]) for i in flat]
        if len({int(mesh.ranks.flat[i]) for i in flat}) > 1:
            raise ValueError("[partition] a split axis spans processes: 'limb' and "
                             "'poly' stay inside one host")

    # -- bookkeeping ---------------------------------------------------------
    def _log(self, kind: str, elems: int):
        if elems:
            for r in self.recs:
                r.add(kind, elems * self.wire)

    def run(self, k: int, fn, *args):
        """fn(*args) as shard k's stage: its work, with the launches it made."""
        before = launch_counts()
        out = fn(*args)
        after = launch_counts()
        i = self.flat[k]
        for r in self.recs:
            r.work[i] = r.work.get(i, 0) + 1
            mine = r.launches.setdefault(i, {})
            for name, v in after.items():
                if v != before[name]:
                    mine[name] = mine.get(name, 0) + v - before[name]
        return out

    def map(self, fn, *lists) -> list:
        """[fn(k, lists[0][k], ...) as shard k's stage for each k]."""
        return [self.run(k, fn, k, *(lst[k] for lst in lists)) for k in range(self.K)]

    def _send(self, x: torch.Tensor, k: int) -> torch.Tensor:
        dev = self.devs[k]
        if _norm(x.device) == dev:
            return x
        if self.wire == 4:
            return x.to(torch.int32).to(dev).to(torch.int64)
        return x.to(dev)

    # -- collectives -----------------------------------------------------------
    def all_gather(self, parts: list, dim: int = -2) -> list:
        """Every shard gets the parts concatenated along dim."""
        if self.K == 1:
            return list(parts)
        self._log("all-gather", (self.K - 1) * sum(p.numel() for p in parts))
        return [torch.cat([self._send(p, k) for p in parts], dim=dim) for k in range(self.K)]

    def broadcast(self, x: torch.Tensor, src: int) -> list:
        if self.K > 1:
            self._log("broadcast", (self.K - 1) * x.numel())
        return [self._send(x, k) for k in range(self.K)]

    def transform(self, xs: list, tabs: list, fn) -> list:
        """fn (an NTT) over column shards xs (..., R, c_k), whose tables
        tabs[k] have R rows: an all-to-all to shards of whole rows of the
        flattened (rows, n), each with its primes' tables, fn, and the
        all-to-all back."""
        R_ = xs[0].shape[-2]
        lead = xs[0].shape[:-2]
        rows = int(np.prod(lead)) * R_
        cuts = M.split(rows, self.K)
        flat = [x.reshape(rows, x.shape[-1]) for x in xs]
        cols = [x.shape[-1] for x in xs]
        moved = sum((b - a) * (sum(cols) - cols[k]) for k, (a, b) in enumerate(cuts))
        self._log("all-to-all", moved)
        blocks = [torch.cat([self._send(f[a:b], k) for f in flat], dim=1)
                  for k, (a, b) in enumerate(cuts)]

        def apply(k, y):
            a, b = cuts[k]
            return fn(y, _row_tables(tabs[k], R_, a, b)) if b > a else y
        done = self.map(apply, blocks)
        self._log("all-to-all", moved)
        out, c0 = [], 0
        for j, c in enumerate(cols):
            out.append(torch.cat([self._send(y[:, c0:c0 + c], j) for y in done])
                       .reshape(*lead, R_, c))
            c0 += c
        return out


def _row_tables(t, R_: int, a: int, b: int):
    """t's tables for rows a..b of a flattened (..., R_, n) tensor."""
    cache = t.__dict__.setdefault("_row_takes", {})
    if (R_, a, b) not in cache:
        cache[R_, a, b] = t.take([r % R_ for r in range(a, b)])
    return cache[R_, a, b]


def groups(x: M.ShardedTensor) -> tuple[str, list[list[int]]]:
    """(kind, groups) of a stacked tensor's sharding: kind 'poly' when its
    last axis is split, else 'limb' (groups of one when the limb axis is
    whole); each group lists its flat mesh positions in split order.  Only
    the leading (batch) axis, the limb axis and the coefficient axis may be
    split."""
    mesh = x.mesh
    spec = tuple(x.spec) + (None,) * (x.ndim - len(x.spec))
    if any(e is not None for e in spec[1:-2]):
        raise ValueError(f"[partition] only the batch, limb and coefficient axes "
                         f"split; got {spec}")
    limb, poly = M._names(spec[-2]), M._names(spec[-1])
    if limb and poly:
        raise ValueError("[partition] the limb and coefficient axes cannot both split")
    names = poly or limb
    if set(names) & set(M._names(spec[0])):
        raise ValueError(f"[partition] one mesh axis splits two tensor axes: {spec}")
    shape = mesh.devices.shape
    axes = [mesh.axis_names.index(a) for a in names]
    out: dict = {}
    for i in range(mesh.size):
        c = np.unravel_index(i, shape)
        key = tuple(c[a] for a in range(len(shape)) if a not in axes)
        order = int(np.ravel_multi_index([c[a] for a in axes], [shape[a] for a in axes])) \
            if axes else 0
        out.setdefault(key, []).append((order, i))
    return ("poly" if poly else "limb"), [[i for _, i in sorted(g)] for g in out.values()]


def _record(*xs) -> tuple[M.CollectiveRecord, list]:
    """A new record holding the inputs' records, and every record a step's
    copies go to (that one and the active recordings)."""
    rec, seen = M.CollectiveRecord(), set()
    for x in xs:
        if isinstance(x, M.ShardedTensor) and id(x.record) not in seen:
            seen.add(id(x.record))
            rec.merge(x.record)
    return rec, [rec] + list(M._ACTIVE)


def _local(x, i: int, dev, mesh: M.Mesh, cols: tuple | None = None):
    """Mesh position i's piece of an operand that is not split like the
    data (the keys): its own shard when x is split over `mesh` (whole, or
    over 'poly'), else the whole tensor copied to dev; cols cuts a whole one
    to a poly shard's columns."""
    if isinstance(x, M.ShardedTensor):
        if x.mesh is not mesh:
            x = x.gather()
        elif any(e is not None for e in x.spec):
            return x.shards[i]
        else:
            x = x.shards[i]
    x = x.to(dev)
    return x[..., cols[0]:cols[1]].contiguous() if cols is not None else x


# ---------------------------------------------------------------------------
# the stages of one group
# ---------------------------------------------------------------------------

def _bfv_multiply_limb(g: Group, parts: list, x1s: list, x2s: list | None) -> list:
    """Evaluator.bfv_multiply_impl over limb shards (x2s None squares)."""
    full1 = g.all_gather(x1s)
    full2 = g.all_gather(x2s) if x2s is not None else [None] * g.K

    def product(k, x1, f1, x2, f2):
        p = parts[k]
        return p["ev"]._bfv_tensor(p["cd"], p["qtab"], p["btab"], p["J"], x1, f1, x2, f2)

    d = g.map(product, x1s, full1, x2s or [None] * g.K, full2)
    dq_full = g.all_gather([q for q, _ in d])
    y = g.map(lambda k, f, b: parts[k]["cd"].rns_tool._floor(f, b, parts[k]["J"]),
              dq_full, [b for _, b in d])
    y_full = g.all_gather(y)
    return g.map(lambda k, f: parts[k]["cd"].rns_tool._b_conv_sk(f, parts[k]["I"]), y_full)


def _keyswitch_limb(g: Group, parts: list, targets: list, keys: list,
                    out_ntt: bool) -> list:
    """Evaluator._switch_key_impl over limb shards: targets[k] the
    coefficient-domain target's rows I_k -> shard k's rows of the result."""
    full = g.all_gather(targets)

    def inner(k, f, key):
        ev, cd, sw = parts[k]["ev"], parts[k]["cd"], parts[k]["sw"]
        return ev._ks_inner(cd, sw, R.ntt_forward(ev._ks_digits(cd, sw, f), sw["otab"]), key)

    accs = g.map(inner, full, keys)
    o = g.K - 1
    sw_o = parts[o]["sw"]
    last = g.run(o, lambda: R.ntt_inverse(accs[o][..., :, sw_o["nq"]:, :].contiguous(),
                                          sw_o["sp_tab"]))

    def finish(k, acc, last_k):
        ev, cd, sw = parts[k]["ev"], parts[k]["cd"], parts[k]["sw"]
        nq = sw["nq"]
        tmp = ev._ks_round(cd, sw, last_k)
        if out_ntt:
            body = acc[..., :, :nq, :]
            tmp = R.ntt_forward(tmp, sw["qtab"])
        else:
            body = R.ntt_inverse(acc[..., :, :nq, :].contiguous(), sw["qtab"])
        return ev._ks_finish(cd, sw, body, tmp)

    return g.map(finish, accs, g.broadcast(last, o))


def _keyswitch_poly(g: Group, parts: list, targets: list, keys: list,
                    out_ntt: bool) -> list:
    """Evaluator._switch_key_impl over column shards."""
    ev, cd = parts[0]["ev"], parts[0]["cd"]     # the stages read only sws[k]'s tables
    sws = [p["sw"] for p in parts]
    D_ = g.map(lambda k, t: ev._ks_digits(cd, sws[k], t), targets)
    D_ = g.transform(D_, [s["otab"] for s in sws], R.ntt_forward)
    accs = g.map(lambda k, d, key: ev._ks_inner(cd, sws[k], d, key), D_, keys)
    nq = sws[0]["nq"]
    last = g.transform([a[..., :, nq:, :] for a in accs], [s["sp_tab"] for s in sws],
                       R.ntt_inverse)
    tmp = g.map(lambda k, x: ev._ks_round(cd, sws[k], x), last)
    qtabs = [s["qtab"] for s in sws]
    if out_ntt:
        body = [a[..., :, :nq, :] for a in accs]
        tmp = g.transform(tmp, qtabs, R.ntt_forward)
    else:
        body = g.transform([a[..., :, :nq, :] for a in accs], qtabs, R.ntt_inverse)
    return g.map(lambda k, b, t: ev._ks_finish(cd, sws[k], b, t), body, tmp)


def _bfv_multiply_poly(g: Group, parts: list, x1s: list, x2s: list | None) -> list:
    """Evaluator.bfv_multiply_impl over column shards."""
    tools = [p["cd"].rns_tool for p in parts]
    qtabs, btabs = [p["qtab"] for p in parts], [tool.bsk_ntt for tool in tools]
    hps = parts[0]["ev"].lift == "hps"

    def prep(xs):
        lifted = g.map(lambda k, x: (tools[k].fast_b_conv_hps if hps else
                                     tools[k].fast_b_conv_m_tilde_sm_mrq)(x), xs)
        return (g.transform(xs, qtabs, R.ntt_forward),
                g.transform(lifted, btabs, R.ntt_forward))

    a_q, a_b = prep(x1s)
    if x2s is None:
        d_q = g.map(lambda k, a: R.dyadic_square(a, qtabs[k]), a_q)
        d_b = g.map(lambda k, a: R.dyadic_square(a, btabs[k]), a_b)
    else:
        b_q, b_b = prep(x2s)
        d_q = g.map(lambda k, a, b: R.dyadic_convolute(a, b, qtabs[k]), a_q, b_q)
        d_b = g.map(lambda k, a, b: R.dyadic_convolute(a, b, btabs[k]), a_b, b_b)
    d_q = g.transform(d_q, qtabs, R.ntt_inverse)
    d_b = g.transform(d_b, btabs, R.ntt_inverse)
    return g.map(lambda k, q, b: tools[k].fast_floor_scale_fast_b_conv_sk(q, b), d_q, d_b)


def _multiply(kind: str, g: Group, parts: list, x1s: list, x2s: list | None) -> list:
    """BatchedEvaluator.multiply over one group."""
    cd = parts[0]["cd"]
    if cd.parms.scheme != SchemeType.BFV:
        if x2s is None:
            return g.map(lambda k, a: R.dyadic_square(a, parts[k]["qtab"]), x1s)
        return g.map(lambda k, a, b: R.dyadic_convolute(a, b, parts[k]["qtab"]), x1s, x2s)
    return (_bfv_multiply_poly if kind == "poly" else _bfv_multiply_limb)(g, parts, x1s, x2s)


def _relinearize(kind: str, g: Group, parts: list, d3s: list, keys: list,
                 ntt_form: bool) -> list:
    """BatchedEvaluator.relinearize over one group."""
    targets = [d[..., 2, :, :].contiguous() for d in d3s]
    if ntt_form:
        if kind == "poly":
            targets = g.transform(targets, [p["qtab"] for p in parts], R.ntt_inverse)
        else:
            targets = g.map(lambda k, t: R.ntt_inverse(t, parts[k]["qtab"]), targets)
    switch = _keyswitch_poly if kind == "poly" else _keyswitch_limb
    sws = switch(g, parts, targets, keys, ntt_form)
    return g.map(lambda k, d, s: P.add(d[..., :2, :, :], s, parts[k]["qtab"]), d3s, sws)


def _galois_limb(g: Group, parts: list, datas: list, keys: list, elt: int,
                 ntt_form: bool) -> list:
    """Evaluator._apply_galois_impl over limb shards."""
    def pre(k, d):
        qtab = parts[k]["qtab"]
        tool = GaloisTool.for_context(parts[k]["cd"])
        if ntt_form:
            return (tool.apply_ntt(d[..., 0, :, :], elt),
                    R.ntt_inverse(tool.apply_ntt(d[..., 1, :, :], elt), qtab))
        gd = tool.apply_coeff(d, elt, qtab)
        return gd[..., 0, :, :], gd[..., 1, :, :].contiguous()

    c0g, targets = zip(*g.map(pre, datas))
    sws = _keyswitch_limb(g, parts, list(targets), keys, ntt_form)
    return g.map(lambda k, s, c: torch.stack([P.add(s[..., 0, :, :], c, parts[k]["qtab"]),
                                              s[..., 1, :, :]], dim=-3), sws, list(c0g))


# ---------------------------------------------------------------------------
# the steps on ShardedTensors
# ---------------------------------------------------------------------------

def _each_group(x: M.ShardedTensor, ev, cd, body, recs) -> list:
    """Run body(kind, group, parts, k_positions) for each of this process's
    groups of x; returns the output shards in flat mesh order."""
    kind, gs = groups(x)
    mesh = x.mesh
    out = [None] * mesh.size
    for flat in gs:
        if not mesh.is_local(flat[0]):
            continue
        g = Group(mesh, flat, recs, 8 if cd.wide else 4)
        K = g.K if kind == "limb" else 1
        parts = [_limb_part(ev, cd, K, k if K > 1 else 0, g.devs[k]) for k in range(g.K)]
        for i, y in zip(flat, body(kind, g, parts)):
            out[i] = y
    return out


def _cols(x: M.ShardedTensor, i: int) -> tuple | None:
    s = x.slices(i)[-1]
    return None if (s.start == 0 and s.stop == x.shape[-1]) else (s.start, s.stop)


def mul_relin(be, d1: M.ShardedTensor, d2: M.ShardedTensor | None, keys) -> M.ShardedTensor:
    """BatchedEvaluator's multiply (or square, d2 None) + relinearize step
    on sharded stacks; the result is sharded as d1."""
    if d2 is not None and d2.sharding != d1.sharding:
        raise ValueError("[partition] both operands must be sharded alike")
    rec, recs = _record(d1, d2, keys)

    def body(kind, g, parts):
        x1s = [d1.shards[i] for i in g.flat]
        x2s = None if d2 is None else [d2.shards[i] for i in g.flat]
        ks = [_local(keys, i, g.devs[k], d1.mesh, _cols(d1, i) if kind == "poly" else None)
              for k, i in enumerate(g.flat)]
        d3 = _multiply(kind, g, parts, x1s, x2s)
        return _relinearize(kind, g, parts, d3, ks, be.ntt_form)

    shards = _each_group(d1, be.ev, be.cd, body, recs)
    shape = (*d1.shape[:-3], 2, *d1.shape[-2:])
    return M.ShardedTensor(shards, shape, d1.sharding, d1.dtype, rec)


def galois(be, d: M.ShardedTensor, keys: tuple, elts: list[int]) -> M.ShardedTensor:
    """BatchedEvaluator's Galois step (one keyswitch round per element) on a
    stack split over 'data' and 'limb'."""
    rec, recs = _record(d, *keys)

    def body(kind, g, parts):
        if kind == "poly":
            raise ValueError("[partition] a Galois automorphism moves coefficients "
                             "across 'poly' shards: split over 'data' or 'limb'")
        datas = [d.shards[i] for i in g.flat]
        for elt, key in zip(elts, keys):
            ks = [_local(key, i, g.devs[k], d.mesh) for k, i in enumerate(g.flat)]
            datas = _galois_limb(g, parts, datas, ks, elt, be.ntt_form)
        return datas

    return M.ShardedTensor(_each_group(d, be.ev, be.cd, body, recs), d.shape, d.sharding,
                           d.dtype, rec)


def per_shard(make_step, args: tuple) -> M.ShardedTensor:
    """A step with no partitioned form, run on each mesh position's own
    batch rows: the sharded inputs must split the batch only; make_step(dev)
    builds the step for a device.  No collective."""
    first = next(a for a in args if isinstance(a, M.ShardedTensor))
    if any(e is not None for e in first.spec[1:]):
        raise ValueError("[partition] this step runs on batch shards only: split "
                         "over 'data' (and 'host'), not 'limb' or 'poly'")
    rec, recs = _record(*args)
    mesh = first.mesh
    shards = [None] * mesh.size
    steps: dict = {}
    for i in range(mesh.size):
        if not mesh.is_local(i):
            continue
        dev = _norm(mesh.devices.flat[i])
        if dev not in steps:
            steps[dev] = make_step(dev)
        local = [a.shards[i] if isinstance(a, M.ShardedTensor) and a.sharding == first.sharding
                 else _local(a, i, dev, mesh) if isinstance(a, (torch.Tensor, M.ShardedTensor))
                 else a for a in args]
        g = Group(mesh, [i], recs, 8)
        shards[i] = g.run(0, steps[dev], *local)
    out0 = next(s for s in shards if s is not None)
    # the output keeps the batch split; its other axes are whole
    spec = (first.spec[0],) + (None,) * (out0.dim() - 1)
    return M.ShardedTensor(shards, (first.shape[0], *out0.shape[1:]), M.Sharding(mesh, spec),
                           out0.dtype, rec)


# ---------------------------------------------------------------------------
# the mesh= paths of the object API
# ---------------------------------------------------------------------------

def _axis(size: int, mesh: M.Mesh, name: str):
    """name when the dimension divides over it, else None: a whole copy on
    each (the JAX package's rule, troy_tpu/core/evaluator.py:937)."""
    return name if size % mesh.shape[name] == 0 else None


def contract(ev, cd, A: torch.Tensor, W_raw: torch.Tensor, rns: bool, p_ntt: bool,
             ct_ntt: bool, mesh: M.Mesh) -> torch.Tensor:
    """Evaluator.multiply_plain_contract's stacked pass with the block rows
    split over 'data' and the limbs over 'limb' where they divide: each
    position contracts its own rows and limbs, no collective.  Returns the
    gathered (bs, os, size, L, n) result."""
    dax = _axis(A.shape[0], mesh, "data")
    lax = _axis(A.shape[-2], mesh, "limb")
    wlax = lax if rns else None
    a_spec = M.Sharding(mesh, (dax, None, None, lax, None))
    As = M.shard(A, a_spec)
    Ws = M.shard(W_raw, M.Sharding(mesh, (None, None, wlax, None)))
    rec, recs = _record()
    outs = [None] * mesh.size
    for i in range(mesh.size):
        if not mesh.is_local(i):
            continue
        g = Group(mesh, [i], recs, 4)
        k = int(np.unravel_index(i, mesh.devices.shape)[mesh.axis_names.index("limb")])
        part = _limb_part(ev, cd, mesh.shape["limb"] if lax else 1, k if lax else 0, g.devs[0])
        outs[i] = g.run(0, part["ev"]._contract, part["cd"], part["qtab"], part["I"],
                        As.shards[i], Ws.shards[i], rns, p_ntt, ct_ntt)
    shape = (A.shape[0], W_raw.shape[1], *A.shape[2:])
    return M.ShardedTensor(outs, shape, a_spec, A.dtype, rec).gather(cd.device)


class _RowLevel:
    """A level's ContextData seen through a limb shard: qtab() gives the
    tables of the shard's rows, every other attribute is the level's."""

    def __init__(self, cd, qtab):
        self._level, self._qtab = cd, qtab

    def qtab(self):
        return self._qtab

    def __getattr__(self, name):
        return getattr(self._level, name)


class RowEvaluator(Evaluator):
    """The evaluator on one limb shard's rows: every level is seen through
    qtab, the tables of those rows, so its limb-local operations (the
    additions, shifts, transforms and the division) run on them alone."""

    def __init__(self, ev: Evaluator, qtab):
        super().__init__(ev.context, ev.lift)
        self._rows_qtab = qtab

    def _cd(self, ct):
        return _RowLevel(super()._cd(ct), self._rows_qtab)


class _MeshCt:
    """A group-stacked (G, 2, L, n) ciphertext split over a mesh: cts[i] is
    flat position i's piece (None where another process holds it)."""

    def __init__(self, cts: list):
        self.cts = cts

    @property
    def is_ntt_form(self) -> bool:
        return next(c for c in self.cts if c is not None).is_ntt_form


class MeshPacker:
    """The PackLWEs tree (LweOpsMixin.pack_rlwe_ciphertexts and its field
    trace) on _MeshCt operands split by `sharding`.  Every operation the
    tree calls is the evaluator's own, run on each position's piece by an
    evaluator of that position's rows (RowEvaluator on a limb shard);
    apply_galois alone is partitioned, its keyswitch the one of mul_relin."""

    pack_rlwe_ciphertexts = LweOpsMixin.pack_rlwe_ciphertexts
    field_trace = LweOpsMixin.field_trace

    def __init__(self, ev, cd, sharding: M.Sharding, shape, recs):
        self.cd, self.sharding, self.shape = cd, sharding, shape
        self.groups, self.evs, self._keys = [], {}, {}
        mesh = sharding.mesh
        for flat in groups(M.ShardedTensor([None] * mesh.size, shape, sharding))[1]:
            if mesh.is_local(flat[0]):
                g = Group(mesh, flat, recs, 8 if cd.wide else 4)
                parts = [_limb_part(ev, cd, g.K, k, g.devs[k]) for k in range(g.K)]
                self.groups.append((g, parts))
                for i, p in zip(flat, parts):
                    self.evs[i] = p["ev"] if p["I"] is None else RowEvaluator(p["ev"], p["qtab"])

    def _cd(self, ct):
        return self.cd

    def __getattr__(self, name: str):
        """The evaluator's operation `name` on each position's piece."""
        if name.startswith("__"):
            raise AttributeError(name)

        def each(*args):
            out = [None] * self.sharding.mesh.size
            for g, _ in self.groups:
                for k, i in enumerate(g.flat):
                    local = [a.cts[i] if isinstance(a, _MeshCt) else a for a in args]
                    out[i] = g.run(k, getattr(self.evs[i], name), *local)
            return _MeshCt(out)
        return each

    def split(self, ct: Ciphertext) -> _MeshCt:
        return _MeshCt([None if x is None else
                        Ciphertext(x, ct.parms_id, is_ntt_form=ct.is_ntt_form, scale=ct.scale,
                                   correction_factor=ct.correction_factor)
                        for x in M.shard(ct.data, self.sharding).shards])

    def gather(self, ct: _MeshCt) -> Ciphertext:
        proto = next(c for c in ct.cts if c is not None)
        return Ciphertext(M.ShardedTensor([None if c is None else c.data for c in ct.cts],
                                          self.shape, self.sharding).gather(self.cd.device),
                          proto.parms_id, is_ntt_form=proto.is_ntt_form, scale=proto.scale,
                          correction_factor=proto.correction_factor)

    def apply_galois(self, ct: _MeshCt, galois_elt: int, glk) -> _MeshCt:
        out = list(ct.cts)
        for g, parts in self.groups:
            ks = []
            for dev in g.devs:
                if (galois_elt, dev) not in self._keys:
                    self._keys[galois_elt, dev] = glk.key(galois_elt).to(dev)
                ks.append(self._keys[galois_elt, dev])
            ys = _galois_limb(g, parts, [ct.cts[i].data for i in g.flat], ks, galois_elt,
                              ct.is_ntt_form)
            for i, y in zip(g.flat, ys):
                out[i] = ct.cts[i].clone()
                out[i].data = y
        return _MeshCt(out)


def pack_groups(ev, cd, positions: list, glk, shift: int, input_interval: int,
                output_interval: int, apply_field_trace: bool, mesh: M.Mesh) -> Ciphertext:
    """Evaluator.pack_rlwe_ciphertexts_batched's tree on (G, 2, L, n)
    stacked ciphertexts (positions, one per input slot) split over 'data'
    (groups) and 'limb' where they divide; returns the gathered result."""
    G, L = positions[0].data.shape[0], positions[0].data.shape[-2]
    sharding = M.Sharding(mesh, (_axis(G, mesh, "data"), None, _axis(L, mesh, "limb"), None))
    rec, recs = _record()
    packer = MeshPacker(ev, cd, sharding, positions[0].data.shape, recs)
    out = packer.pack_rlwe_ciphertexts([packer.split(x) for x in positions], glk, shift,
                                       input_interval, output_interval, apply_field_trace)
    return packer.gather(out)
