#!/usr/bin/env python3
"""Ablations of the base-conversion kernel K3 (csrc/bconv.cu), built side by
side and timed in turns on one GPU, to show what each part of its design
buys.

    python3 scripts/torch_bconv_variants.py [variant ...]

Each variant is a kernel source with textual substitutions, all built in
parallel (nvcc with the port's flags, as scripts/torch_ntt_variants.py
builds its variants) into troy_tpu_torch/build/bconv_variants/; the first
kernel (csrc/bconv_first.cu, through ops/bconv_cuda.run_first) runs beside
them as "first".  At the conversions of the flagship HPS step
(chip_smoke.py's configuration: n = 8192, 7 x 30-bit primes, batch 16) and
at ring2k's and the decrypt step's, every variant runs on the same input
and is timed by CUDA events around a CUDA graph of 50 launches, in the
order listed and then in reverse, keeping the lower; "(wrong)" marks a
result other than the plain version's, as the measurement-only variant
gives.

From csrc/bconv.cu:

  committed     the source as it is: one CTA a tile, one column a thread;
  prologue      the first kernel's prologue put back: each CTA divides
                2^64 - 1 by every output modulus behind a second barrier;
  tables_first  the tables copied before the first input loads are issued
                (the source issues them first);
  threads_256   256 threads a CTA;
  smem_inputs   the scaled inputs through shared memory at every L_in (the
                source keeps them in registers up to L_in = 16);
  copy_first    the source, on a contiguous copy of a strided input made
                in the timed call (the route before the kernel read strided
                rows; the same as committed on contiguous input);
  no_arith      no products and no reductions: each output is an xor of the
                scaled inputs (the kernel's loads and stores alone; wrong);
  streaming     loads and stores with the evict-first hint (__ldcs, __stcs).

From scripts/torch_bconv_columns.cu (the planned form: V columns a thread
and a grid-stride loop over the tiles):

  columns       the source as it is: V = 1 and one CTA a tile, the design
                of csrc/bconv.cu (the baseline of the four below);
  persistent    a persistent grid, the SM count times the CTAs an SM holds,
                walking the tiles by the grid-stride loop;
  persistent_4  the same with at most 4 CTAs an SM;
  pairs         a column pair a thread, 16-byte accesses (the scalar path
                where n is odd or a row is not 16-byte aligned);
  quads         two column pairs a thread, 2 kThreads apart, up to L_in =
                8 (a pair above).

And first, the first kernel (csrc/bconv_first.cu), on a contiguous copy
made beforehand.  A name "a+b" applies a's substitutions, then b's, to
their one source (pairs+persistent: the design first planned, column pairs
on a persistent grid).

Needs one CUDA device and nvcc; imports nothing of jax.
"""

from __future__ import annotations

import ctypes
import pathlib
import shutil
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from troy_tpu_torch.ops import _cuda_build, bconv as BC, bconv_cuda  # noqa: E402

KERNEL = _cuda_build.CSRC / "bconv.cu"
COLUMNS = ROOT / "scripts" / "torch_bconv_columns.cu"
GRID = "  const long long grid = std::min<long long>(a.tiles, 0x7fffffffLL);  // one CTA a tile"
COLS = "__host__ __device__ constexpr int cols_for(int L) { return 1; }"


def persistent(cap: str) -> list:
    """The grid at most the SM count times the CTAs an SM holds (`cap`)."""
    return [(GRID, "  int per_sm = 0, device = 0, sms = 0;\n"
                   "  ctas_per_sm(form, &per_sm);\n"
                   "  cudaGetDevice(&device);\n"
                   "  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);\n"
                   f"  const long long grid = std::min<long long>(a.tiles, 1LL * sms * {cap});")]


VARIANTS = {  # name: (source, substitutions)
    "committed": (KERNEL, []),
    "prologue": (KERNEL, [
        ("    __syncthreads();\n    uint32_t t[L];",
         "    __syncthreads();\n"
         "    for (int o = threadIdx.x; o < a.L_out; o += kThreads) {\n"
         "      uint4 c = smem[L_in + o];\n"
         "      const uint64_t r = ~0ull / c.x;\n"
         "      c.y = static_cast<uint32_t>(r);\n"
         "      c.z = static_cast<uint32_t>(r >> 32);\n"
         "      smem[L_in + o] = c;\n"
         "    }\n"
         "    __syncthreads();\n    uint32_t t[L];")]),
    "tables_first": (KERNEL, [
        ("    int64_t raw[L];\n"
         "#pragma unroll\n"
         "    for (int i = 0; i < L; ++i) raw[i] = pl.col < n ? __ldg(pl.x + i * n + pl.col) : 0;\n"
         "    for (int i = threadIdx.x; i < n_tab; i += kThreads) smem[i] = a.tables[i];\n"
         "    __syncthreads();\n",
         "    for (int i = threadIdx.x; i < n_tab; i += kThreads) smem[i] = a.tables[i];\n"
         "    __syncthreads();\n"
         "    int64_t raw[L];\n"
         "#pragma unroll\n"
         "    for (int i = 0; i < L; ++i) raw[i] = pl.col < n ? __ldg(pl.x + i * n + pl.col) : 0;\n")]),
    "threads_256": (KERNEL, [("constexpr int kThreads = 128;", "constexpr int kThreads = 256;")]),
    "smem_inputs": (KERNEL, [("int form_of(int L_in) { return L_in <= kRegLimbs ? L_in : 0; }",
                              "int form_of(int L_in) { return 0; }")]),
    "copy_first": (KERNEL, []),
    "no_arith": (KERNEL, [
        ("          if (4 * i4 + k < L) acc += static_cast<uint64_t>(t[4 * i4 + k]) * word(w, k);",
         "          if (4 * i4 + k < L) acc ^= t[4 * i4 + k];"),
        ("            if (--left == 0) {", "            if (false) {"),
        ("  acc = troy::barrett_reduce64(acc, p, ratio);\n  if (pl.col < n)",
         "  acc ^= p;\n  if (pl.col < n)")]),
    "streaming": (KERNEL, [
        ("__ldg(", "__ldcs("),
        ("  if (pl.col < n) pl.y[o * n + pl.col] = static_cast<int64_t>(acc);",
         "  if (pl.col < n)\n"
         "    __stcs(reinterpret_cast<long long*>(pl.y) + o * n + pl.col, static_cast<long long>(acc));")]),
    "columns": (COLUMNS, []),
    "persistent": (COLUMNS, persistent("per_sm")),
    "persistent_4": (COLUMNS, persistent("std::min(per_sm, 4)")),
    "pairs": (COLUMNS, [(COLS, COLS.replace("{ return 1; }", "{ return 2; }"))]),
    "quads": (COLUMNS, [(COLS, COLS.replace("{ return 1; }",
                                             "{ return L == 0 ? 2 : (L <= 8 ? 4 : 2); }"))]),
    "first": (None, []),
}
DEFAULT = list(VARIANTS)
BUILT_ELSEWHERE = ("copy_first", "first")   # the committed library, the port's build


def variant_source(name: str) -> str:
    """A variant's source text; "a+b" applies a's substitutions, then b's,
    to the one source they share.  Raises if a substitution finds no text."""
    parts = name.split("+")
    sources = {VARIANTS[part][0] for part in parts}
    if len(sources) != 1:
        raise ValueError(f"[variants] {name}: its parts have different sources")
    text = sources.pop().read_text()
    for old, new in (sub for part in parts for sub in VARIANTS[part][1]):
        if old not in text:
            raise RuntimeError(f"[variants] {name}: {old[:60]!r} not in its source")
        text = text.replace(old, new)
    return text


def build(names: list[str]) -> dict:
    """Each variant compiled into its own library, all in parallel, with
    ptxas's registers of the L_in = 6 and 8 forms printed."""
    root = _cuda_build.BUILD_DIR / "bconv_variants"
    shutil.rmtree(root, ignore_errors=True)
    procs = {}
    for name in names:
        d = root / name.replace("+", "_")
        d.mkdir(parents=True)
        (d / "bconv.cu").write_text(variant_source(name))
        shutil.copy(_cuda_build.CSRC / "ntt_common.cuh", d)
        cmd = [_cuda_build._nvcc(), *_cuda_build.COMPILE_FLAGS, "-Xptxas", "-v", "-shared",
               "-o", str(d / "lib.so"), str(d / "bconv.cu")]
        procs[name] = (d, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                           text=True))
    libs = {}
    for name, (d, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"[variants] {name} does not build:\n{err[-4000:]}")
        regs, entry = [], ""
        for line in err.splitlines():
            if "Compiling entry function" in line:
                entry = line
            elif "registers" in line and any(k in entry for k in ("kernelILi6E", "kernelILi8E")):
                regs.append(line.split(":", 1)[-1].strip())
        print(f"[build] {name}: {'; '.join(regs[:2])}", flush=True)
        libs[name] = ctypes.CDLL(str(d / "lib.so"))
    return libs


def cases(tool, dev) -> dict:
    """label: (lead, tables, layout), as chip_smoke.py's [times] cases."""
    return {
        "floor (16, 3, 6) -> 9": ((16, 3), tool.ff_tables, "contiguous"),
        "floor (64, 3, 6) -> 9": ((64, 3), tool.ff_tables, "contiguous"),
        "SK joined, strided (16, 3, 8 of 9) -> 7": ((16, 3), tool._rows("q", None)["sk"],
                                                     "strided"),
        "decrypt step (16, 6) -> {t, gamma}": ((16,), tool.conv_q_to_t_gamma.tables,
                                              "contiguous"),
        "ring2k (16, 3) -> {2^31, gamma}": ((16,), chip_smoke.t_gamma_tables(dev, 31),
                                           "contiguous")}


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("torch_bconv_variants: no CUDA device", file=sys.stderr)
        return 1
    names = argv or DEFAULT
    dev = chip_smoke.cuda_device()
    gpu = chip_smoke.gpu_line()
    print(f"[device] {gpu}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    built = [n for n in names if n not in BUILT_ELSEWHERE]
    if "copy_first" in names and "committed" not in built:
        built.append("committed")
    libs = build(built)
    if "first" in names:
        _cuda_build.build()
        _cuda_build.load()
    tool = chip_smoke.build_context(dev).first_context_data().rns_tool
    gen = torch.Generator(device=dev).manual_seed(13)

    def launch(name: str, x: torch.Tensor, tabs: BC.BConvTables) -> torch.Tensor:
        if name == "first":
            return bconv_cuda.run_first(x, tabs)
        if name == "copy_first":
            name, x = "committed", x.contiguous()
        fn = libs[name].troy_bconv
        fn.argtypes = bconv_cuda._ARGTYPES["troy_bconv"]
        fn.restype = ctypes.c_int
        n = x.shape[-1]
        out = torch.empty((*x.shape[:-2], tabs.L_out, n), dtype=torch.int64, device=dev)
        err = fn(x.data_ptr(), out.data_ptr(), tabs.kernel_tables.data_ptr(),
                 x.numel() // (tabs.L_in * n), bconv_cuda.row_stride(x, tabs.L_in), tabs.L_in,
                 tabs.L_out, n, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"[variants] {name} launch failed: CUDA error {err}")
        return out

    for label, (lead, tabs, layout) in cases(tool, dev).items():
        x = chip_smoke.bconv_input(lead, tabs, layout, gen)
        xc = x.contiguous()
        plain = BC.base_convert_plain(x, tabs)
        arg = {n: xc if n == "first" else x for n in names}
        right = {n: torch.equal(launch(n, arg[n], tabs), plain) for n in names}
        times = {}
        for name in names + names[::-1]:
            us = chip_smoke.graph_us(lambda: launch(name, arg[name], tabs))
            times[name] = min(us, times.get(name, us))
        bound, by = chip_smoke.bconv_bound(tuple(x.shape), tabs.L_out)
        print(f"[variants] {gpu}: base_convert {label} {tuple(x.shape)}, bound {bound:.3f} us "
              f"({by}): " + ", ".join(
                  f"{n} {times[n]:.3f} us ({100 * bound / times[n]:.1f}%)"
                  f"{'' if right[n] else ' (wrong)'}" for n in names), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
