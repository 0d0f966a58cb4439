"""The port's example twins under examples/torch/: one for each
examples/*.py, each named as its original, importing neither jax nor the
JAX package, and differing from its original only in its imports, the
device= argument of HeContext.create, jax.jit (15) and its arrays (jnp ->
torch, 21), and for 30 its device list and the comments that named JAX's
mechanisms; the memory-model twin (20) shows torch's caching allocator
instead of XLA's placement.  The twins whose flows have no other port test
run here on the CPU at their own sizes: 1, 2, 3, 6, 15, 20 and 30."""

import contextlib
import difflib
import io
import runpy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
JAX_DIR, TWINS = ROOT / "examples", ROOT / "examples" / "torch"
ORIGINALS = sorted(p.name for p in JAX_DIR.glob("*.py") if p.name != "common.py")
WAITING: dict = {}
REWRITTEN = {"20_memory_model.py": "shows torch's caching allocator, not XLA placement",
             "21_device_client_ops.py": "its arrays are torch tensors on the device, and "
                                        "its docstring quotes no TPU time"}
# a changed line of an original, and of a twin, is one of these
CHANGED_ORIGINAL = ("import common", "from troy_tpu", "context = HeContext.create(",
                    "ctx = HeContext.create(", "cctx = HeContext.create(",
                    "ctx_b = HeContext.create(", "import jax", "step = jax.jit(")
CHANGED_TWIN = ("from common import DEVICE", "from troy_tpu_torch", "context = HeContext.create(",
                "ctx = HeContext.create(", "cctx = HeContext.create(",
                "ctx_b = HeContext.create(", "step = batched.build_mul_relin_step(")
# 30_parallelism: its device count, device lists, jit calls and the lines
# that named JAX's mechanisms
CHANGED_30 = (("Run with 8 virtual devices", "XLA_FLAGS=", "\"XLA_FLAGS=", "if jax.device_count()",
               "print(f\"only {jax.device_count()}", "raise SystemExit(0)",
               "data_axis = min(", "mesh = M.make_mesh(", "out = jax.jit(",
               "M.replicate(keys, hmesh))", "# On a real pod", "# tests/parallel/",
               "hmesh = M.make_multihost_mesh(", "# GSPMD partitions", "amesh = M.make_mesh("),
              ("Run with 8 shards", "python3 examples/torch/", "DEVICES = ", "# Across hosts",
               "# (scripts/torch_multiproc", "data_axis = min(", "mesh = M.make_mesh(",
               "out = batched.build_mul_relin_step(", "# tests/test_torch_mesh.py",
               "if len(DEVICES)", "hmesh = M.make_multihost_mesh(", "# the port splits",
               "amesh = M.make_mesh(", "import torch"))


def test_a_twin_for_every_example():
    twins = sorted(p.name for p in TWINS.glob("*.py") if p.name != "common.py")
    assert twins == [n for n in ORIGINALS if n not in WAITING]
    assert len(twins) == 18


@pytest.mark.parametrize("name", [n for n in ORIGINALS if n not in WAITING])
def test_twin_differs_only_where_allowed(name):
    src = (TWINS / name).read_text()
    for line in src.splitlines():
        s = line.strip()
        assert not s.startswith(("import jax", "from jax", "import troy_tpu.", "from troy_tpu.",
                                 "from troy_tpu ", "import common")), f"{name}: {s}"
        assert "jnp." not in s and "jax." not in s, f"{name}: {s}"
    assert "from common import DEVICE" in src
    assert "device=DEVICE" in src or name == "20_memory_model.py"
    if name in REWRITTEN:
        return
    orig = (JAX_DIR / name).read_text().splitlines()
    extra = CHANGED_30 if name == "30_parallelism.py" else ((), ())
    for d in difflib.ndiff(orig, src.splitlines()):
        if d.startswith("- "):
            assert d[2:].lstrip().startswith(CHANGED_ORIGINAL + extra[0]), f"{name}: {d}"
        elif d.startswith("+ "):
            assert d[2:].lstrip().startswith(CHANGED_TWIN + extra[1]), f"{name}: {d}"
    for line in src.splitlines():
        if "HeContext.create(" in line:
            assert line.rstrip().split("#")[0].rstrip().endswith("device=DEVICE)"), line


def run_twin(name: str) -> list[str]:
    """The twin run as a script in this process with --device cpu; its
    printed lines."""
    argv, path0 = sys.argv, list(sys.path)
    sys.modules.pop("common", None)
    sys.argv = [str(TWINS / name), "--device", "cpu"]
    sys.path.insert(0, str(TWINS))
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            runpy.run_path(str(TWINS / name), run_name="__main__")
    finally:
        sys.argv, sys.path[:] = argv, path0
        sys.modules.pop("common", None)
    return buf.getvalue().splitlines()


@pytest.mark.parametrize("name,ok", [
    ("1_bfv_basics.py", "x^2 OK"),
    ("2_encoders.py", "CKKS device-encode roundtrip max err"),
    ("3_levels.py", "mod switch chain OK"),
    ("6_rotation.py", "rotations OK"),
    ("15_batched_operation.py", "batched multiply+relinearize of 4 ciphertexts OK"),
    ("20_memory_model.py", "memory model OK"),
    ("30_parallelism.py", "multi-device BumbleBee matmul (contraction + pack) OK")])
def test_twin_runs_on_the_cpu(name, ok):
    lines = run_twin(name)
    assert lines and lines[-1].startswith(ok), lines[-3:]
    if name == "3_levels.py":
        assert [line.split()[1] for line in lines if line.startswith("chain ")] == \
            ["0", "1", "2", "3"]
    if name == "2_encoders.py":
        assert "BatchEncoder SIMD roundtrip OK; slots = 4096" in lines
