"""The port's two bench twins on the CPU at a small size:
scripts/torch_troybench.py (the eager object-API loop of
scripts/troybench.py) and scripts/torch_troybench_perop.py (the batched
per-operation matrix of scripts/troybench_tpu.py), at n = 1024, batch 2 and
two repetitions, on 4 x 30-bit primes and on {60, 40, 40, 60}.  Every printed row is read back by
scripts/compare_bench.py's parse; every op list equals the JAX script's for
its scheme; every per-op step's output equals the port's unbatched object
API on the same ciphertexts (and decrypts right)."""

import contextlib
import io
import re
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "scripts"))
import compare_bench  # noqa: E402
import torch_troybench as EAGER  # noqa: E402
import torch_troybench_perop as PEROP  # noqa: E402

N, BATCH, REPS = 1024, 2, 2


def jax_eager_ops(scheme: str) -> list[str]:
    """The names scripts/troybench.py times for a scheme, from its source:
    its bench_op calls in order, each `if scheme == SchemeType.CKKS:` branch
    (and its else) taken as the scheme takes it."""
    src = (ROOT / "scripts" / "troybench.py").read_text()
    body = src[src.index("reps = args.reps"):src.index("if not args.no_test_correct")]
    ops, take = [], True
    for line in body.splitlines():
        if line.startswith("    ") and not line.startswith("     "):
            stmt = line.strip()
            if stmt == "if scheme == SchemeType.CKKS:":
                take = scheme == "ckks"
                continue
            if stmt == "else:":
                take = not take
                continue
            take = True
        ops += [n for n in re.findall(r'bench_op\("([^"]+)"', line) if take and n not in ops]
    return ops


def jax_perop_rows(scheme: str) -> list[str]:
    """The rows scripts/troybench_tpu.py prints for a scheme: its host rows,
    sorted, then its steps in order, from its source."""
    src = (ROOT / "scripts" / "troybench_tpu.py").read_text()
    host = sorted(re.findall(r'timeit\("([^"]+)"', src))
    body = src[src.index("def build_steps"):src.index("def slope_time")]
    steps = re.findall(r'steps\[("[^"]+"|rot_name|conj_name)\]', body)
    names = []
    for s in steps:
        if s == "rot_name":
            s = "rotate_vector(1)" if scheme == "ckks" else "rotate_rows(1)"
        elif s == "conj_name":
            s = "complex_conjugate" if scheme == "ckks" else "rotate_columns"
        else:
            s = s.strip('"')
        if s == "rescale_to_next" and scheme != "ckks":
            continue
        if s not in names:
            names.append(s)
    return host + names


@pytest.mark.parametrize("scheme", ["bfv", "bgv", "ckks"])
def test_eager_bench(scheme, tmp_path):
    args = EAGER.parse_args(["--scheme", scheme, "-n", str(N), "--limbs", "4", "--reps",
                             str(REPS), "--device", "cpu"])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = EAGER.run(args)
    assert EAGER.op_names(scheme) == jax_eager_ops(scheme)
    assert res["correct"] is (None if scheme == "ckks" else True)
    path = tmp_path / "eager.txt"
    path.write_text(buf.getvalue())
    parsed = compare_bench.parse(str(path))
    assert list(parsed) == EAGER.op_names(scheme)
    assert all(v > 0 for v in parsed.values())


PEROP_CASES = [("bfv", "30,30,30,30"), ("bgv", "30,30,30,30"), ("ckks", "30,30,30,30"),
               ("bfv", "60,40,40,60")]


@pytest.fixture(scope="module", params=PEROP_CASES, ids=lambda c: f"{c[0]}-{c[1]}")
def perop(request):
    scheme, qbits = request.param
    argv = ["--scheme", scheme, "-n", str(N), "--batch", str(BATCH), "--reps", str(REPS),
            "--device", "cpu", "--q-bits", qbits]
    args = PEROP.parse_args(argv)
    s = PEROP.setup(args, "cpu")
    return s, PEROP.build_steps(s)


def test_perop_rows_match_the_object_api(perop):
    """Every step's output: row 0 bit for bit the object API's result on the
    same ciphertexts, a whole ciphertext decrypting to its slots, the
    chained shape kept."""
    s, steps = perop
    for name, row in steps.items():
        out = row.step(row.cur, row.aux)
        assert out.shape == row.cur.shape and out.dtype == row.cur.dtype, name
        assert PEROP.check_row(s, row, out), name


def test_perop_table_parses(perop, tmp_path, monkeypatch):
    """Every row of the table (host rows, then the steps) in the JAX script's
    order, read back by compare_bench.parse.  A run's time is stubbed at
    1 ms a step, so each row's slope is exactly 1 ms whatever the CPU does."""
    s, steps = perop
    monkeypatch.setattr(PEROP, "chained_seconds", lambda row, reps, dev: reps * 1e-3)
    lines = []
    times = PEROP.table(s, steps, reps=REPS, out=lines.append, host_reps=1)
    names = sorted(n for n in times if n.endswith(" (host)")) + list(steps)
    assert names == jax_perop_rows(s.args.scheme)
    assert lines[1] == "| op | ms / batched step | us / ciphertext |"
    path = tmp_path / "perop.md"
    path.write_text("\n".join(lines) + "\n")
    parsed = compare_bench.parse(str(path))
    assert list(parsed) == names
    for name in names:
        assert parsed[name] == pytest.approx(float(f"{times[name]:.3f}") * 1e6)
    assert all(times[name] == pytest.approx(1.0) for name in steps)


def test_slope_time_runs_the_chain(perop):
    """slope_ms on the CPU's clock: a finite time from chained runs whose
    output is the next input."""
    s, steps = perop
    calls = []
    row = steps["negate"]
    step = row.step
    row.step = lambda cur, aux: calls.append(cur) or step(cur, aux)
    try:
        ms = PEROP.slope_ms(row, 3, 1, s.dev)
    finally:
        row.step = step
    assert ms == ms and abs(ms) < 1e4
    assert len(calls) == 3 * (3 + 1)
    assert calls[1] is row.cur and calls[2] is not row.cur  # the 3-run chains its calls


def test_slope_reps():
    assert PEROP.rep_counts("negate", 100) == (800, 160)
    assert PEROP.rep_counts("multiply", 100) == (100, 20)
    assert PEROP.rep_counts("multiply", 2) == (2, 1)
