#!/usr/bin/env python3
"""Where K12's time goes inside a CTA, on the card: writes a copy of
``csrc/rwkv6_wkv.cu`` with ``clock64()`` stamps at the phase boundaries of
each of its four kernels (thread 0 of each CTA), builds it with the flags of
``repro_torch.kernels._build``, runs each kernel at the rwkv6 slice (bf16,
B 2, S 512, H 64, N = P = 64, chunk 32) and prints, for each, its CUDA-event
time a launch and the mean and largest cycles a CTA spends in each phase:

    python3 tools/wkv_phases.py

The phases: the local kernels [loads and cumsum, the scaled tile, the tile's
product and store, the ticket and (last CTA) the row's scan]; the forward
[loads and cumsum, the diagonal blocks, their sums, y]; the backward [loads
and cumsum, the staged k and dA's diagonal blocks, the diagonal blocks, their
sums, the query and key products with their epilogues, dlog w and dw]. The
copy and the library go to ``build/wkv_phases/``. A CTA's cycles include the
time it shares its SM with the other resident CTAs.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
from repro_torch.kernels import _build  # noqa: E402

OUT = ROOT / "build" / "wkv_phases"
MAX_CTAS = 4096
HEAD = f"""
__device__ long long g_prof[4 * {MAX_CTAS} * 8];
#define PROF(kind, i) do {{ if (threadIdx.x == 0 && blockIdx.x < {MAX_CTAS}) \\
    g_prof[((kind) * {MAX_CTAS} + blockIdx.x) * 8 + (i)] = clock64(); }} while (0)
"""
MARKS = {0: 5, 1: 5, 2: 5, 3: 7}  # stamps of each kernel: fwd_local, fwd, bwd_local, bwd


def instrument() -> str:
    src = (_build.CSRC / "rwkv6_wkv.cu").read_text()
    src = src.replace("namespace {\n\nusing bf16", HEAD + "namespace {\n\nusing bf16", 1)

    def after(anchor, text, occurrence=1):
        nonlocal src
        i = -1
        for _ in range(occurrence):
            i = src.index(anchor, i + 1)
        j = i + len(anchor)
        src = src[:j] + text + src[j:]

    def before(anchor, text):
        nonlocal src
        i = src.index(anchor)
        src = src[:i] + text + src[i:]

    K = "BWD ? 2 : 0"
    before("  load_chunk<T>(x + base, nullptr, yv + base", f"  PROF({K}, 0);\n")
    after("  chunk_cum(d, CUM, CE, TOT);\n", f"  PROF({K}, 1);\n")
    after("  __syncthreads();  // cum, cum_excl and X are read: OUT may take their place\n", f"  PROF({K}, 2);\n")
    before("  scan_row(tiles, tbuf, counters, row, BWD ? dstate", f"  PROF({K}, 3);\n")
    after("  scan_row(tiles, tbuf, counters, row, BWD ? dstate : nullptr, BWD ? nullptr : state_out, BWD, d);\n", f"  PROF({K}, 4);\n")
    before("  const float* S = states + ((long long)row * d.nc + c) * d.n * d.n;", "  PROF(1, 0);\n")
    after("  diag_blocks<false>(t, d);\n  __syncthreads();\n", "  PROF(1, 2);\n")
    before("  stage_decayed(t.k, t.cum, t.tot, true, d, t.kh, t.kh + d.L * LD);\n  diag_blocks<false>", "  PROF(1, 1);\n")
    after("  diag_blocks<false>(t, d);\n  __syncthreads();\n  PROF(1, 2);\n  sum_parts(t, d);\n  __syncthreads();\n", "  PROF(1, 3);\n")
    after("      if (l < valid) y[base + l * tstride + p] = from_f<T>(yacc[j][i]);\n    }\n", "  PROF(1, 4);\n")
    before("  const float* S = states + tile;", "  PROF(3, 0);\n")
    before("  stage_decayed(t.k, t.cum, t.tot, true, d, t.kh, t.kh + d.L * LD);\n\n  const int warp", "  PROF(3, 1);\n")
    after("  __syncthreads();\n  diag_blocks<true>(t, d);\n  __syncthreads();\n", "  PROF(3, 3);\n")
    before("  diag_blocks<true>(t, d);\n", "  PROF(3, 2);\n")
    after("  sum_parts(t, d);\n  __syncthreads();\n", "  PROF(3, 4);\n", occurrence=2)
    before("  __syncthreads();\n  // a column a thread: dtotal, then dlog w", "  PROF(3, 5);\n")
    after("    du_part[((long long)row * d.nc + c) * d.n + n] = du;\n  }\n", "  PROF(3, 6);\n")
    src += f"""
extern "C" int wkv_prof_read(void* dst) {{
  return (int)cudaMemcpyFromSymbol(dst, g_prof, sizeof(long long) * 4 * {MAX_CTAS} * 8);
}}
"""
    # the two local kernels share one body: one set of stamps, kind 0 or 2
    if src.count("PROF(") != 1 + MARKS[0] + MARKS[1] + MARKS[3]:
        raise RuntimeError("a phase anchor of csrc/rwkv6_wkv.cu moved: update tools/wkv_phases.py")
    return src


def main() -> int:
    if not torch.cuda.is_available():
        print("wkv_phases: needs a CUDA GPU", file=sys.stderr)
        return 2
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "rwkv6_wkv_phases.cu").write_text(instrument())
    lib_path = OUT / "rwkv6_wkv_phases.so"
    res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib_path), str(OUT / "rwkv6_wkv_phases.cu")],
                         capture_output=True, text=True)
    if res.returncode:
        print(res.stdout[-4000:], res.stderr[-4000:], file=sys.stderr)
        return 1
    lib = ctypes.CDLL(str(lib_path))
    P, I = ctypes.c_void_p, ctypes.c_int
    for name, n in (("wkv_fwd_local_launch", 7), ("wkv_fwd_launch", 7), ("wkv_bwd_local_launch", 7),
                    ("wkv_bwd_launch", 13)):
        f = getattr(lib, name)
        f.argtypes, f.restype = [P] * n + [I] * 6 + [P], I
    lib.wkv_prof_read.argtypes, lib.wkv_prof_read.restype = [P], I
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    b, s, h, n, L, dt = 2, 512, 64, 64, 32, torch.bfloat16
    r, k, v, dy = (torch.randn(b, s, h, n, generator=g, device=dev).to(dt) for _ in range(4))
    w = 0.2 + 0.79 * torch.rand(b, s, h, n, generator=g, device=dev)
    u = torch.randn(h, n, generator=g, device=dev).to(dt)
    nc, rows = -(-s // L), b * h
    states, dws = (torch.empty(rows, nc, n, n, device=dev) for _ in range(2))
    tbuf, cnt = torch.empty(rows * nc * n, device=dev), torch.zeros(rows, dtype=torch.int32, device=dev)
    state, dstate = torch.empty(b, h, n, n, device=dev), torch.randn(b, h, n, n, generator=g, device=dev)
    y, dr, dk, dv = (torch.empty_like(r) for _ in range(4))
    dw, dup = torch.empty_like(w), torch.empty(rows, nc, n, device=dev)
    st = torch.cuda.current_stream().cuda_stream
    p = lambda t: t.data_ptr()  # noqa: E731
    calls = {
        "wkv_fwd_local": lambda: lib.wkv_fwd_local_launch(p(k), p(v), p(w), p(states), p(tbuf), p(state), p(cnt),
                                                          b, s, h, n, L, 1, st),
        "wkv_fwd": lambda: lib.wkv_fwd_launch(p(r), p(k), p(v), p(w), p(u), p(y), p(states), b, s, h, n, L, 1, st),
        "wkv_bwd_local": lambda: lib.wkv_bwd_local_launch(p(r), p(w), p(dy), p(dstate), p(dws), p(tbuf), p(cnt),
                                                          b, s, h, n, L, 1, st),
        "wkv_bwd": lambda: lib.wkv_bwd_launch(p(r), p(k), p(v), p(w), p(u), p(dy), p(states), p(dws), p(dr), p(dk),
                                              p(dv), p(dw), p(dup), b, s, h, n, L, 1, st),
    }
    print(f"{card}; bf16 B {b} S {s} H {h} N {n} chunk {L}: {rows * nc} CTAs a kernel")
    for kind, (name, fn) in enumerate(calls.items()):
        for _ in range(3):
            if fn() != 0:
                raise RuntimeError(f"{name}: launch failed")
        torch.cuda.synchronize()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(20):
            fn()
        e1.record()
        torch.cuda.synchronize()
        buf = np.zeros(4 * MAX_CTAS * 8, dtype=np.int64)
        if lib.wkv_prof_read(buf.ctypes.data) != 0:
            raise RuntimeError("wkv_phases: reading the stamps failed")
        stamps = buf.reshape(4, MAX_CTAS, 8)[kind, :min(rows * nc, MAX_CTAS), :MARKS[kind]].astype(np.float64)
        phases = np.diff(stamps, axis=1)
        print(f"  {name}: {e0.elapsed_time(e1) / 20 * 1e3:.1f} us a launch; cycles a CTA, phase means "
              f"{[round(x) for x in phases.mean(0)]}, largest {[round(x) for x in phases.max(0)]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
