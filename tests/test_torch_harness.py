"""The port's harness modules against the JAX package's: utils/timer.py
(the printed lines, which scripts/compare_bench.py reads back),
ops/reduction.py (each reduction on the same numpy inputs from a seed:
u32 values, fast and wide residues, an empty and an odd-sized array) and
utils/poly_string.py (the same strings)."""

import contextlib
import io
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from troy_tpu.ops import reduction as JR
from troy_tpu.utils import poly_string as JS, timer as JT
from troy_tpu_torch.ops import reduction as TR
from troy_tpu_torch.utils import poly_string as TS, timer as TT

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "scripts"))
import compare_bench  # noqa: E402

RNG = np.random.default_rng(0x4A2)
FAST_Q = [1073479681, 1073184769, 1072496641]      # 30-bit NTT primes (n = 8192)
WIDE_Q = [(1 << 60) - 93, (1 << 40) - 87]


def t64(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def printed(fn) -> list[str]:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn()
    return buf.getvalue().splitlines()


@pytest.mark.parametrize("ns", [0, 999, 1000, 12345.6, 999999, 10 ** 6, 123456789,
                                10 ** 9, 3.5e10])
def test_format_duration_matches_jax(ns):
    assert TT._format_duration(ns) == JT._format_duration(ns)


def test_timer_lines_parse(tmp_path):
    """Timer.print's lines and print_communication's are the JAX package's
    format; compare_bench.parse reads every timed name back in its unit (and
    no byte count)."""
    timer = TT.Timer()
    timer.register("encode_simd")
    for name, probe in (("encode_simd", torch.ones(3)), ("rotate(1)", [torch.ones(2)]),
                        ("mul+relin", {"a": torch.zeros(1)})):
        for _ in range(2):
            timer.tick(name)
            timer.tock(name, probe)
    timer.add_communication("sent", 3 << 20)
    lines = printed(timer.print) + printed(timer.print_communication)
    jt = JT.Timer()
    for name in ("encode_simd", "rotate(1)", "mul+relin"):
        jt._entries[name] = list(timer._entries[name])
    jt.add_communication("sent", 3 << 20)
    assert lines == printed(jt.print) + printed(jt.print_communication)
    assert all(line.startswith("\t") and "(2 runs, total " in line for line in lines[:3])
    path = tmp_path / "out.txt"
    path.write_text("\n".join(lines) + "\n")
    got = compare_bench.parse(str(path))
    assert sorted(got) == sorted(["encode_simd", "rotate(1)", "mul+relin"])  # not the MB line
    for name in ("encode_simd", "rotate(1)", "mul+relin"):
        total, count, _ = timer._entries[name]
        want = float(TT._format_duration(total / count).split()[0])
        unit = TT._format_duration(total / count).split()[1]
        assert got[name] == pytest.approx(want * compare_bench._SCALE[unit])
    with pytest.raises(ValueError, match="not ticked"):
        timer.tock("encode_simd")
    timer.clear()
    assert printed(timer.print) == []


def test_timer_once_line():
    with contextlib.redirect_stdout(io.StringIO()) as buf:
        with TT.TimerOnce("setup") as t:
            pass
    assert t.elapsed_ns > 0
    assert buf.getvalue() == f"setup: {TT._format_duration(t.elapsed_ns)}\n"
    quiet = TT.TimerOnce("quiet", print_on_exit=False)
    assert printed(quiet.finish) == [] and quiet.elapsed_ns > 0


def test_profile_trace_writes_a_trace(tmp_path):
    with TT.profile_trace(str(tmp_path)):
        (torch.arange(64) * 3).sum()
    assert any(p.name.endswith(".json") for p in tmp_path.iterdir())


def inputs():
    u32 = RNG.integers(0, 1 << 32, 4097, dtype=np.uint64).astype(np.uint32)
    fast = np.stack([RNG.integers(0, q, 1024, dtype=np.uint64) for q in FAST_Q]).astype(np.uint32)
    odd = RNG.integers(0, 1 << 32, (1 << 15) + 3, dtype=np.uint64).astype(np.uint32)
    sparse = np.where(RNG.random(999) < 0.3, 0, RNG.integers(1, 1 << 32, 999)).astype(np.uint32)
    return {"u32": u32, "fast residues": fast, "odd-sized": odd, "sparse": sparse,
            "empty": np.zeros(0, np.uint32)}


@pytest.mark.parametrize("case", list(inputs()))
def test_reductions_match_jax(case):
    x = inputs()[case]
    jx, tx = jnp.asarray(x), t64(x)
    for name in ("max_value", "min_value"):
        if x.size == 0:
            with pytest.raises(ValueError):
                getattr(JR, name)(jx)
            with pytest.raises(ValueError):
                getattr(TR, name)(tx)
        else:
            assert int(getattr(TR, name)(tx)) == int(getattr(JR, name)(jx))
    assert int(TR.nonzero_count(tx)) == int(JR.nonzero_count(jx))
    assert int(TR.sum_values(tx)) == int(JR.sum_values(jx))
    hi, lo = JR.sum_values_wide(jx)
    wide = TR.sum_values_wide(tx)
    assert wide.dtype == torch.int64 and int(wide) == (int(hi) << 32) + int(lo)
    if x.size:
        q = FAST_Q[0] if case == "fast residues" else (1 << 32) - 5
        xq = x if case == "fast residues" else x % np.uint32(q)
        assert int(TR.max_centered_magnitude(t64(xq), q)) == \
            int(JR.max_centered_magnitude(jnp.asarray(xq), np.uint32(q)))


def test_reductions_of_wide_residues():
    """40-60-bit residues, one int64 word each: the port's reductions equal
    numpy's on the same values; the JAX package's u32 reductions agree where
    the sum reads only the low words (sum_values mod 2^32) and on which words
    are zero (its (hi, lo) layout)."""
    x = np.stack([RNG.integers(0, q, 2049, dtype=np.uint64) for q in WIDE_Q])
    x[0, :7] = 0
    tx = t64(x)
    assert int(TR.max_value(tx)) == int(x.max()) and int(TR.min_value(tx)) == 0
    assert int(TR.nonzero_count(tx)) == int(np.count_nonzero(x))
    hi, lo = (x >> 32).astype(np.uint32), (x & 0xFFFFFFFF).astype(np.uint32)
    assert int(TR.nonzero_count(tx)) == int(JR.nonzero_count(jnp.asarray(hi | lo)))
    assert int(TR.sum_values(tx)) == int(JR.sum_values(jnp.asarray(lo)))
    for row, q in zip(x, WIDE_Q):
        want = max(min(int(v), q - int(v)) for v in row)
        assert int(TR.max_centered_magnitude(t64(row), q)) == want


def test_sum_values_wide_bound():
    """Values below 2^32, fewer than 2^31 of them: the largest sum is below
    2^63, so one int64 word holds it exactly."""
    x = torch.full((1 << 12,), (1 << 32) - 1, dtype=torch.int64)
    assert int(TR.sum_values_wide(x)) == ((1 << 32) - 1) << 12
    assert ((1 << 32) - 1) * ((1 << 31) - 1) < 1 << 63


@pytest.mark.parametrize("coeffs", [[0, 0, 0], [5], [1, 0, 255, 0, 16], [7, 0, 0, 1],
                                    [0, (1 << 29) + 11, 3]])
def test_poly_strings_match_jax(coeffs):
    a = np.asarray(coeffs, dtype=np.uint32)
    for form in (t64(a), a, list(coeffs)):
        assert TS.poly_to_hex_string(form) == JS.poly_to_hex_string(jnp.asarray(a))
        assert TS.poly_to_dec_string(form) == JS.poly_to_dec_string(jnp.asarray(a))


def test_poly_strings_wide_and_errors():
    wide = [3, 0, (1 << 60) + 7]
    w = torch.tensor(wide, dtype=torch.int64)
    assert TS.poly_to_hex_string(w) == JS.poly_to_hex_string(np.asarray(wide, np.uint64))
    assert TS.poly_to_dec_string(w) == JS.poly_to_dec_string(np.asarray(wide, np.uint64))
    for v in (0, 10, 1 << 61):
        assert TS.uint_to_hex_string(v) == JS.uint_to_hex_string(v)
        assert TS.uint_to_dec_string(v) == JS.uint_to_dec_string(v)
    for mod in (TS, JS):
        with pytest.raises(ValueError):
            mod.uint_to_hex_string(-1)
        with pytest.raises(ValueError):
            mod.poly_to_hex_string(np.zeros((2, 2), np.uint32))
    with pytest.raises(ValueError):
        TS.poly_to_hex_string(torch.zeros((2, 2), dtype=torch.int64))
