"""The PyTorch port imports torch and never jax, nor the JAX package."""

import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "troy_tpu_torch"
MODULES = sorted(
    ".".join((p.parent if p.name == "__init__.py" else p.with_suffix("")).relative_to(ROOT).parts)
    for p in PORT.rglob("*.py"))


def test_module_list_covers_the_kernel_wrappers():
    for m in ("ops._cuda_build", "ops.ntt_cuda", "ops.bconv", "ops.bconv_cuda",
              "ops.fused_mul", "ops.fused_mul_cuda"):
        assert "troy_tpu_torch." + m in MODULES


def test_module_list_covers_the_rotation_slice():
    for m in ("ops.galois", "ops.dyadic", "ops.poly", "core.keys", "core.keygen",
              "core.rlwe", "core.encryptor", "core.evaluator", "rns.rns_tool",
              "rns.scaling", "parallel.batched", "interop"):
        assert "troy_tpu_torch." + m in MODULES


def test_module_list_covers_the_ckks_slice():
    for m in ("native", "utils.random", "core.ckks_encoder", "core.decryptor",
              "rns.rns_base"):
        assert "troy_tpu_torch." + m in MODULES


def test_module_list_covers_the_app_slice():
    for m in ("core.lwe", "core.lwe_ops", "app", "app.cipher2d", "app.encoder_adapter",
              "app.matmul", "app.conv2d"):
        assert "troy_tpu_torch." + m in MODULES


def test_module_list_covers_the_wire_slice():
    for m in ("utils.random", "utils.serialize", "core.ciphertext", "core.ckks_encoder",
              "parallel.batched", "app.matmul", "app.conv2d", "app.cipher2d"):
        assert "troy_tpu_torch." + m in MODULES


def test_module_list_covers_the_ring2k_and_wide_slice():
    for m in ("ops.u64", "ops.ntt64", "ops.rp", "ops.limb", "rns.rns_tool64",
              "app.ring2k"):
        assert "troy_tpu_torch." + m in MODULES


def test_import_leaves_jax_out():
    code = (
        "import sys, importlib\n"
        "import troy_tpu_torch\n"
        f"for m in {MODULES!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'troy_tpu' or m.startswith('troy_tpu.'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_sources_import_no_jax():
    """Neither the port nor chip_smoke.py (which runs where jax is absent)
    imports jax or the JAX package, even lazily inside a function."""
    for path in sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]:
        for line in path.read_text().splitlines():
            s = line.strip()
            assert not (s.startswith(("import jax", "from jax", "import troy_tpu.",
                                      "from troy_tpu.", "from troy_tpu "))
                        or s == "import troy_tpu"), f"{path}: {s}"
