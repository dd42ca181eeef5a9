#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU (an H100 is the target).

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. Print the card (``nvidia-smi`` name and power limit) and the torch/CUDA
   versions; build the hand-written kernels from ``src/repro_torch/csrc``
   (one ``nvcc`` per source, all started together) and print the build time.
2. Hold each kernel against its plain PyTorch version on the card, at the
   serving slice's shapes, in bf16 and f32, with the stated bound; time the
   kernel, the plain version and one library call as a yardstick.
3. The slice: (a) a 2-layer qwen2-7b at full attention width in f32,
   teacher-forced through ``paged_step`` on the card and on the CPU (plain
   versions), logits compared; (b) full-width qwen2-7b in bf16 with random
   weights from a seeded generator, 8 ragged requests through
   ``BatchedEngine``: every request gets exactly ``max_new`` in-vocab
   tokens, logits are finite, every kernel's launch count is non-zero and
   equals what the number of forwards implies, and a second run of the
   same trace gives the same tokens and scheduler events.
4. One JSON line with every kernel's numbers, then the device line last.

Exits with code 2 and prints no result when there is no GPU, or when it is
run outside a checkout of the repository.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores

SLOTS, MAX_LEN, PAGE, CHUNK = 4, 512, 16, 32
N_REQUESTS, MAX_NEW, SEED = 8, 32, 0


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int = 50) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls (CUDA events, warm L2)."""
    import torch

    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, flops: float = 0.0, flop_rate: float = F32_FLOPS):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / flop_rate
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def bf16_ulp(p):
    import torch

    _, e = torch.frexp(p.float())
    return torch.ldexp(torch.ones_like(p, dtype=torch.float32), e - 8)


def check_rmsnorm(dev, gen):
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.rmsnorm import ops, ref

    d, eps, worst, timing = 3584, 1e-6, 0.0, {}
    for dtype in (torch.bfloat16, torch.float32):
        for rows in (1, 4, 32):
            x = torch.randn(rows, d, generator=gen, device=dev).to(dtype)
            scale = (1 + 0.1 * torch.randn(d, generator=gen, device=dev)).to(dtype)
            got, want = ops.rmsnorm_2d(x, scale, eps=eps), ref.rmsnorm(x, scale, eps)
            err = (got.float() - want.float()).abs()
            if dtype == torch.bfloat16:
                lim, stated = bf16_ulp(want), "1 bf16 ulp of plain"
            else:
                lim, stated = 2e-5 * want.float().abs() + 1e-6, "2e-5*|plain| + 1e-6"
            ok = bool((err <= lim).all())
            rel = float((err / want.float().abs().clamp_min(1e-30)).max())
            rec = dict(kernel="K7 rmsnorm", dtype=str(dtype).split(".")[-1], rows=rows, d=d,
                       max_abs_err=float(err.max()), max_rel_err=rel, bound=stated, ok=ok)
            if dtype == torch.bfloat16:
                worst = max(worst, float(err.max()))
            if dtype == torch.bfloat16 and rows in (4, 32):
                rec["ms"] = time_ms(lambda: ops.rmsnorm_2d(x, scale, eps=eps))
                rec["plain_ms"] = time_ms(lambda: ref.rmsnorm(x, scale, eps))
                rec["library_ms"] = time_ms(lambda: F.rms_norm(x, (d,), weight=scale, eps=eps))
                rec["bound_ms"], rec["bound_by"] = bound(2 * rows * d * 2 + d * 2, 4 * rows * d)
                timing[rows] = rec
            log(json.dumps(rec))
            if not ok:
                raise AssertionError(f"K7 rmsnorm kernel disagrees with plain: {rec}")
    return worst, timing


def _tables(gen, dev, slots, maxp, lengths_list):
    """Page tables giving each non-idle slot maxp distinct pages (a random
    permutation of 1..slots*maxp); idle slots (length 0) keep a zero row."""
    import torch

    perm = torch.randperm(slots * maxp, generator=gen, device=dev).to(torch.int32) + 1
    pt = perm.reshape(slots, maxp).contiguous()
    lens = torch.tensor(lengths_list, dtype=torch.int32, device=dev)
    pt[lens == 0] = 0
    return pt, lens


def check_paged_append(dev, gen):
    import torch

    from repro_torch.kernels.paged_attn import ops, ref

    kv, d, maxp = 4, 128, MAX_LEN // PAGE
    num_pages = SLOTS * maxp + 1
    worst, timing = 0.0, {}
    # ragged lengths, page-boundary crossings, the last position maxp*page-1,
    # positions clamped past the table end (T=32 from 500), idle slot 0
    cases = {1: [0, 17, 300, maxp * PAGE - 1], 32: [0, 17, 290, 500]}
    for dtype in (torch.bfloat16, torch.float32):
        for t, lens_list in cases.items():
            pt, lens = _tables(gen, dev, SLOTS, maxp, lens_list)
            pool0 = torch.randn(num_pages, PAGE, kv, d, generator=gen, device=dev).to(dtype)
            new = torch.randn(SLOTS, t, kv, d, generator=gen, device=dev).to(dtype)
            got = ops.paged_append_(pool0.clone(), new, pt, lens)
            want = ref.paged_append_(pool0.clone(), new, pt, lens)
            err = float((got.float() - want.float()).abs().max())
            ok = err == 0.0 and not torch.equal(got, pool0)
            rec = dict(kernel="K10 paged_append", dtype=str(dtype).split(".")[-1], slots=SLOTS, T=t,
                       lengths=lens_list, max_abs_err=err, bound="bitwise (same last-writer rule)", ok=ok)
            if dtype == torch.bfloat16:
                worst = max(worst, err)
                pool = pool0.clone()
                rec["ms"] = time_ms(lambda: ops.paged_append_(pool, new, pt, lens))
                rec["plain_ms"] = time_ms(lambda: ref.paged_append_(pool, new, pt, lens))
                page_ids, offs = ref.append_targets(pt, lens, t, PAGE)
                flat = (page_ids.long() * PAGE + offs.long()).reshape(-1)
                keep = ref._last_writer(flat)
                idx, rows = flat[keep], new.reshape(-1, kv, d)[keep]
                view = pool.view(-1, kv, d)
                rec["library_ms"] = time_ms(lambda: view.index_put_((idx,), rows))
                row_bytes = kv * d * 2
                rec["bound_ms"], rec["bound_by"] = bound(2 * SLOTS * t * row_bytes + 4 * SLOTS + 4 * SLOTS * t)
                timing[t] = rec
            log(json.dumps(rec))
            if not ok:
                raise AssertionError(f"K10 paged_append kernel disagrees with plain: {rec}")
    return worst, timing


def check_paged_attend(dev, gen):
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.paged_attn import ops, ref

    kv, g, d, maxp = 4, 7, 128, MAX_LEN // PAGE
    num_pages = SLOTS * maxp + 1
    lens_list = [0, 17, 300, maxp * PAGE - 1]
    worst, timing = 0.0, None
    for dtype in (torch.bfloat16, torch.float32):
        for window in (None, 64):
            pt, lens = _tables(gen, dev, SLOTS, maxp, lens_list)
            pool_k = torch.randn(num_pages, PAGE, kv, d, generator=gen, device=dev).to(dtype)
            pool_v = torch.randn(num_pages, PAGE, kv, d, generator=gen, device=dev).to(dtype)
            q = (torch.randn(SLOTS, kv, g, d, generator=gen, device=dev) / d**0.5).to(dtype)
            got = ops.paged_attend_decode(q, pool_k, pool_v, pt, lens, window=window)
            want = ref.paged_attend_gqa(
                q.reshape(SLOTS, 1, kv * g, d), pool_k, pool_v, pt, lens, window=window
            ).reshape(SLOTS, kv, g, d)
            err = (got.float() - want).abs()
            if dtype == torch.bfloat16:
                lim, stated = 2.0**-8 * want.abs() + 1e-5, "2^-8*|plain| + 1e-5 (one bf16 rounding)"
            else:
                lim, stated = torch.full_like(want, 1e-5), "1e-5 absolute"
            ok = bool((err <= lim).all()) and bool(torch.isfinite(got).all())
            rec = dict(kernel="K9 paged_attend", dtype=str(dtype).split(".")[-1], slots=SLOTS, kv=kv, g=g, d=d,
                       window=window, lengths=lens_list, max_abs_err=float(err.max()),
                       max_rel_err=float((err / want.abs().clamp_min(1e-30)).max()), bound=stated, ok=ok)
            if dtype == torch.bfloat16:
                worst = max(worst, float(err.max()))
            if dtype == torch.bfloat16 and window is None:
                rec["ms"] = time_ms(lambda: ops.paged_attend_decode(q, pool_k, pool_v, pt, lens, window=None))
                rec["plain_ms"] = time_ms(lambda: ref.paged_attend_gqa(
                    q.reshape(SLOTS, 1, kv * g, d), pool_k, pool_v, pt, lens, window=None))
                # yardstick: SDPA over the already gathered cache, q as (S, KV, G, D)
                kg = ref.paged_gather(pool_k, pt).permute(0, 2, 1, 3).contiguous()
                vg = ref.paged_gather(pool_v, pt).permute(0, 2, 1, 3).contiguous()
                mask = (torch.arange(maxp * PAGE, device=dev)[None, :] <= lens[:, None])[:, None, None, :]
                rec["library_ms"] = time_ms(lambda: F.scaled_dot_product_attention(q, kg, vg, attn_mask=mask, scale=1.0))
                visible = sum(min(n, maxp * PAGE - 1) + 1 for n in lens_list)
                pages = sum(min(n, maxp * PAGE - 1) // PAGE + 1 for n in lens_list)
                nbytes = 2 * q.numel() * 2 + 2 * visible * kv * d * 2 + 4 * pages + 4 * SLOTS
                rec["bound_ms"], rec["bound_by"] = bound(nbytes, 4.0 * visible * kv * g * d)
                timing = rec
            log(json.dumps(rec))
            if not ok:
                raise AssertionError(f"K9 paged_attend kernel disagrees with plain: {rec}")
    return worst, timing


# ---------------------------------------------------------------------------
# phase 3: the slice
# ---------------------------------------------------------------------------


def check_small_model_against_cpu(dev):
    """2 layers of qwen2-7b at full attention width (28 heads, 4 KV heads,
    head_dim 128, d_model 3584), narrow FFN and vocab, f32: four 32-token
    prefill chunks and 8 joint decode steps through paged_step with the
    kernels on the card and with the plain versions on the CPU, same weights
    and tables.
    Bound: |Δlogits| ≤ 2e-4 + 2e-4·|cpu| (f32 matmuls on cuBLAS vs the CPU
    BLAS sum in other orders; TF32 is off)."""
    import numpy as np
    import torch

    from repro_torch.config import get_arch
    from repro_torch.models import transformer as T
    from repro_torch.serving import init_paged_pools, paged_step

    cfg = dataclasses.replace(get_arch("qwen2-7b").model, num_layers=2, d_ff=1024, vocab_size=1024, dtype="float32")
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    p_dev = T.init_model(cfg, gen, device=dev)
    # random QKV biases, so the bias path is exercised (init is zeros)
    for name in ("bq", "bk", "bv"):
        b = p_dev["seg0"]["attn"][name]
        b.copy_(0.1 * torch.randn(b.shape, generator=gen, device=dev))
    p_cpu = _tree_to(p_dev, "cpu")
    rng = np.random.default_rng(SEED)
    maxp = 8
    pt = np.arange(1, SLOTS * maxp + 1, dtype=np.int32).reshape(SLOTS, maxp)
    pools = {"cuda": init_paged_pools(cfg, SLOTS * maxp + 1, PAGE, device=dev),
             "cpu": init_paged_pools(cfg, SLOTS * maxp + 1, PAGE, device="cpu")}
    params = {"cuda": p_dev, "cpu": p_cpu}

    def chunk(slot, start):
        toks = rng.integers(0, cfg.vocab_size, (1, CHUNK)).astype(np.int32)
        return toks, pt[slot : slot + 1], np.asarray([start], np.int32)

    # prefill chunks (slots 1, 2 to 32 tokens, slot 3 to 64), then 8 joint
    # decode steps with slot 0 idle on the trash page
    steps = [chunk(1, 0), chunk(2, 0), chunk(3, 0), chunk(3, CHUNK)]
    for i in range(8):
        tables = pt.copy()
        tables[0] = 0
        lens = np.asarray([0, CHUNK + i, CHUNK + i, 2 * CHUNK + i], np.int32)
        steps.append((rng.integers(0, cfg.vocab_size, (SLOTS, 1)).astype(np.int32), tables, lens))
    worst = 0.0
    for toks_np, tab, ln in steps:
        out = {}
        for key, device in (("cuda", dev), ("cpu", torch.device("cpu"))):
            logits, _ = paged_step(cfg, params[key], torch.from_numpy(toks_np).to(device), pools[key],
                                   torch.from_numpy(np.ascontiguousarray(tab)).to(device),
                                   torch.from_numpy(ln).to(device))
            out[key] = logits.float().cpu()
        err = (out["cuda"] - out["cpu"]).abs()
        lim = 2e-4 + 2e-4 * out["cpu"].abs()
        if not bool((err <= lim).all()) or not bool(torch.isfinite(out["cuda"]).all()):
            raise AssertionError(f"small-model logits: card vs CPU max |Δ| {float(err.max())}")
        worst = max(worst, float(err.max()))
    log(json.dumps(dict(check="qwen2-7b 2-layer f32, card kernels vs CPU plain", forwards=len(steps),
                        max_abs_err=worst, bound="2e-4 + 2e-4*|cpu|", ok=True)))


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return tree.to(device).contiguous()


def make_trace(vocab: int):
    import numpy as np

    rng = np.random.default_rng(SEED)
    lens = rng.integers(17, 301, size=N_REQUESTS)
    lens = [int(n) + 1 if n % PAGE == 0 or n % CHUNK == 0 else int(n) for n in lens]
    return [(f"r{i}", rng.integers(0, vocab, (n,)).astype(np.int32)) for i, n in enumerate(lens)]


def serve_full_width(dev, kernels):
    import torch

    from repro_torch.config import get_arch
    from repro_torch.models import transformer as T
    from repro_torch.models.params import num_params
    from repro_torch.serving import BatchedEngine

    class TimedEngine(BatchedEngine):
        """Times each forward (synchronised) and checks its logits are finite."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.ms = {"prefill": [], "decode": []}
            self.finite = True

        def _run_step(self, tokens, page_tables, lengths):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits = super()._run_step(tokens, page_tables, lengths)
            self.finite &= bool(torch.isfinite(logits).all())
            self.ms["decode" if tokens.shape[1] == 1 else "prefill"].append((time.perf_counter() - t0) * 1e3)
            if logits.shape[-1] != self.cfg.vocab_size:
                raise AssertionError(f"logits shape {tuple(logits.shape)}")
            return logits

    cfg = get_arch("qwen2-7b").model
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = T.init_model(cfg, gen, device=dev)
    torch.cuda.synchronize()
    n_params = num_params(params)
    log(f"full-width {cfg.name}: {n_params} params in {cfg.dtype}, init {time.perf_counter() - t0:.1f}s")
    trace = make_trace(cfg.vocab_size)

    def engine(cls):
        eng = cls(cfg, params, slots=SLOTS, max_len=MAX_LEN, page_size=PAGE, chunk=CHUNK, device=dev)
        for rid, prompt in trace:
            eng.submit(rid, prompt, MAX_NEW)
        return eng

    warm = BatchedEngine(cfg, params, slots=SLOTS, max_len=MAX_LEN, page_size=PAGE, chunk=CHUNK, device=dev)
    warm.submit("warm", trace[0][1][:40], 4)
    warm.run()

    # the main path: a plain engine, counters from zero
    for k in kernels:
        k.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    eng = engine(BatchedEngine)
    t0 = time.perf_counter()
    res1 = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in kernels}
    peak = torch.cuda.max_memory_allocated()
    events1 = list(eng.sched.events)

    # the same trace again, each forward timed and its logits checked
    timed = engine(TimedEngine)
    res2 = timed.run()
    if list(timed.sched.events) != events1:
        raise AssertionError("scheduler events differ between two runs of one trace")
    if sorted(res1) != sorted(res2) or any(res1[r].tolist() != res2[r].tolist() for r in res1):
        raise AssertionError("tokens differ between two runs of one trace")
    if not timed.finite:
        raise AssertionError("non-finite logits")
    for rid, _ in trace:
        toks = res1[rid]
        if len(toks) != MAX_NEW or toks.min() < 0 or toks.max() >= cfg.vocab_size:
            raise AssertionError(f"{rid}: {len(toks)} tokens, range [{toks.min()}, {toks.max()}]")
    profile = profile_run(engine(BatchedEngine), res1, events1)
    n_pre, n_dec = len(timed.ms["prefill"]), len(timed.ms["decode"])
    layers = cfg.num_layers
    expect = {"rmsnorm": (2 * layers + 1) * (n_pre + n_dec), "paged_append": 2 * layers * (n_pre + n_dec),
              "paged_attend": layers * n_dec}
    if launches != expect:
        raise AssertionError(f"launch counts {launches} != implied by {n_pre} prefill + {n_dec} decode forwards: {expect}")
    if any(n == 0 for n in launches.values()):
        raise AssertionError(f"a kernel was not launched on the main path: {launches}")
    admits = sum(1 for e in events1 if e[0] == "admit")
    total = sum(len(v) for v in res1.values())
    med = lambda xs: sorted(xs)[len(xs) // 2]
    summary = dict(
        slice=f"{cfg.name} full width bf16", requests=len(trace), prompt_lens=[len(p) for _, p in trace],
        max_new=MAX_NEW, slots=SLOTS, max_len=MAX_LEN, page_size=PAGE, chunk=CHUNK, admits=admits,
        tokens=total, wall_s=wall, tok_s=total / wall, prefill_forwards=n_pre, decode_forwards=n_dec,
        decode_step_ms_median=med(timed.ms["decode"]), prefill_chunk_ms_median=med(timed.ms["prefill"]),
        peak_mem_bytes=peak, launches=launches, deterministic_replay=True, profile=profile,
    )
    return summary


def profile_run(eng, want_results, want_events):
    """The same trace once more under torch.profiler: device busy time (sum of
    kernel durations; one stream, so kernels do not overlap) against the
    run's wall time, and the kernels that take the most device time. The
    profiler's own per-op cost lengthens this run's wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = eng.run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    if list(eng.sched.events) != want_events or any(res[r].tolist() != want_results[r].tolist() for r in res):
        raise AssertionError("profiled run differs from the first run of the trace")
    averages = prof.key_averages()
    kern = [e for e in averages if e.device_type == DeviceType.CUDA]
    if not kern:
        return dict(device_busy_us="not measured (no device events in the trace)", wall_us=wall_us)
    busy_us = sum(e.self_device_time_total for e in kern)
    cpu_ops = sum(e.count for e in averages if e.device_type == DeviceType.CPU and e.key.startswith("aten::"))
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:10]
    return dict(
        wall_us=wall_us, device_busy_us=busy_us, device_busy_share=busy_us / wall_us,
        kernel_launches=sum(e.count for e in kern), aten_ops=cpu_ops,
        top=[dict(name=e.key[:90], count=e.count, device_us=e.self_device_time_total) for e in top],
    )


# ---------------------------------------------------------------------------


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.kernels import _build, all_kernels

    # phase 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(smi)
    card = f"{smi}"
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    kernels = all_kernels()
    t0 = time.perf_counter()
    _build.build_all(kernels)
    log(f"built {len(kernels)} kernels in {time.perf_counter() - t0:.1f}s")
    for k in kernels:
        for line in k.build_log.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {k.name}: {line.strip()}")

    # phase 2
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rms_err, rms_t = check_rmsnorm(dev, gen)
    app_err, app_t = check_paged_append(dev, gen)
    att_err, att_t = check_paged_attend(dev, gen)

    # phase 3
    check_small_model_against_cpu(dev)
    summary = serve_full_width(dev, kernels)
    summary["card"] = card
    log(json.dumps(summary))

    # phase 4
    launches = summary["launches"]
    rows = [
        ("rmsnorm", "K7 rmsnorm_2d", "src/repro/kernels/rmsnorm/kernel.py:26", rms_err, rms_t[4],
         "bf16 rows=4 d=3584 (decode)"),
        ("paged_attend", "K9 paged_attend_decode", "src/repro/kernels/paged_attn/kernel.py:89", att_err, att_t,
         "bf16 S=4 KV=4 G=7 D=128 page=16 maxp=32 lengths 0/17/300/511"),
        ("paged_append", "K10 paged_append_decode", "src/repro/kernels/paged_attn/kernel.py:145", app_err, app_t[1],
         "bf16 S=4 T=1 KV=4 D=128 (decode)"),
    ]
    out = []
    for name, label, replaces, err, t, shape in rows:
        out.append(dict(
            name=label, route="cuda", source=f"src/repro_torch/csrc/{name}.cu", replaces=replaces,
            launches=launches[name], max_abs_err=err, ms=t["ms"], plain_ms=t["plain_ms"],
            bound_ms=t["bound_ms"], bound_by=t["bound_by"], library_ms=t["library_ms"], shape=shape,
            status="ok", card=card,
        ))
    log(json.dumps({"kernels": out}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
