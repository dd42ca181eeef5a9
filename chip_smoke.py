#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU (an H100 is the target).

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. Print the card (``nvidia-smi`` name and power limit) and the torch/CUDA
   versions; build the hand-written kernels from ``src/repro_torch/csrc``
   (one ``nvcc`` per source, all started together) and print the build time.
2. Hold each kernel against its plain PyTorch version on the card, with the
   stated bound, and time the kernel, the plain version and one library
   call as a yardstick: (a) the serving kernels K7, K9, K10 at the serving
   slice's shapes, in bf16 and f32; (b) the training kernels K1 ``sgd_step``,
   K2 ``adamw_step``, K3 ``pullback_mean_momentum``, K4 ``pullback_mean``
   (masked and unmasked, ``mean_pre``) and K5 ``anchor_mix`` (beside
   ``torch.lerp_`` and a ``copy_``) in f32 and bf16, at the classifier's
   plane (16 x 17,408) and on a 4 x 2^27 plane whose times read bandwidth;
   all five bitwise against their plain versions; (c) the
   LM training kernels, K6 flash attention (forward, dQ and dK/dV
   backward kernels) at the LM slice's shape (B 2, S 512, 28 heads, 4 KV
   heads, D 128, causal), a ragged S with a padded K, a window and a
   q_offset, and K7's backward at 7 and 1024 rows, in f32 and bf16, each
   against its plain version (the backward also against torch autograd of
   the plain forward) with the stated bounds; timed beside SDPA (forward;
   backward alone; both) and F.rms_norm's backward, and K6 also at
   B 1, S 4096, where the operations bound the work.
3. The serving slice: (a) a 2-layer qwen2-7b at full attention width in f32,
   teacher-forced through ``paged_step`` on the card and on the CPU (plain
   versions), logits compared; (b) full-width qwen2-7b in bf16 with random
   weights from a seeded generator, 8 ragged requests through
   ``BatchedEngine``: every request gets exactly ``max_new`` in-vocab
   tokens, logits are finite, every kernel's launch count is non-zero and
   equals what the number of forwards implies, and a second run of the
   same trace gives the same tokens and scheduler events.
4. The training slice, ``examples/quickstart.py``'s configuration at its
   real width through ``repro_torch.api.Experiment``: 16 workers, the
   30,000-sample task, batch 32 a worker, SGD + Nesterov, lr warmup then
   step decay. Overlap-Local-SGD (tau 2, alpha 0.6, beta 0.7) for 600 steps
   from zeroed counters: K1 launches = steps x buckets and K3 launches =
   rounds x buckets; a second run gives identical losses and plane; its
   first 20 rounds agree with the same run on the CPU (plain versions).
   Then sync-SGD for 600 steps, 20 rounds with AdamW (K2) and 20 with
   beta = 0 (K4), each with its launch counts, and one profiled overlap run.
   Then 20 rounds of each remaining strategy: gossip_ring and gossip_exp
   (K5), gossip_full, easgd and sparse_anchor k 0.25 (K4), cocod,
   delayed_avg (delay 1) and powersgd rank 2 (K1 only), each with exact
   launch counts, bitwise replay and its losses against the CPU's.
5. The LM slice through ``repro_torch.api.Experiment(arch=...)`` with the
   training CLI's defaults (Overlap-Local-SGD tau 2, alpha 0.6, beta 0.7;
   SGD lr 1e-2, Nesterov 0.9): (a) the reduced qwen2-7b with 2 KV heads,
   f32, seq 128, 2 workers, 3 rounds, on the card and on the CPU, losses
   compared; (b) full-width qwen2-7b cut to 2 layers, bf16, 4 workers,
   seq 512, 3 rounds from zeroed counters: finite losses, launch counts
   exactly steps x workers x layers (K6 forward and each backward kernel),
   steps x workers x (2 layers + 1) (K7 forward and backward), steps x
   buckets (K1), rounds x buckets (K3); a non-zero gradient in every leaf of
   every worker in the first step; a second run gives the same losses and
   final plane bit for bit; a finite eval_loss; rounds/s, step ms, peak
   memory and one profiled round. (c) This slice's path: the same model
   and data trained with gossip_ring (push-sum over a ring of 4), 3 rounds
   from zeroed counters: K5 once a boundary and K3/K4 never, the other
   counts as in (b); bitwise replay; K5 bitwise at the plane's last
   columns; rounds/s, step ms, peak memory and one profiled round.
6. One JSON line with every kernel's numbers (K1-K5, K6 forward and
   backward, K7 forward and backward, K9, K10), then the device line last.

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
        for rows in (1, 4, 32, 1024):
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
            if dtype == torch.bfloat16 and rows in (4, 32, 1024):
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
# phase 2 (b): the training kernels K1-K4 against their plain versions
# ---------------------------------------------------------------------------

# (m, n) planes: the classifier slice's own (16 workers x 17,408 elements, the
# padded MLP) and a large one, 4 x 2^27, whose times read bandwidth and not
# launch overhead
TRAIN_SHAPES = {"slice": (16, 17408), "large": (4, 1 << 27)}
TIMING_ITERS = {"slice": 50, "large": 10}


def _name(dtype) -> str:
    return str(dtype).split(".")[-1]


def _ulp_check(got, want, dtype):
    """f32: bitwise. bf16: within one bf16 ulp of the plain value (both
    round at the same points, so 0 is expected). Returns (ok, max_abs_err)."""
    import torch

    err = (got.float() - want.float()).abs()
    if dtype == torch.float32:
        return bool(torch.equal(got, want)), float(err.max())
    return bool((err <= bf16_ulp(want)).all()), float(err.max())


def _free():
    import torch

    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def check_opt_step(dev, gen):
    """K1 sgd_step and K2 adamw_step against ref.py on the card, f32 and bf16,
    at both shapes; times in f32 beside the plain version, torch's fused
    optimizer op on the same buffers, and the bytes bound."""
    import torch

    from repro_torch.kernels.opt_step import ops, ref

    worst = {"K1": 0.0, "K2": 0.0}
    timing = {"K1": {}, "K2": {}}
    sgd_kw = dict(momentum=0.9, nesterov=True, weight_decay=1e-4)
    adam_kw = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=1e-4)
    for shape_name, (w, n) in TRAIN_SHAPES.items():
        for dtype in (torch.float32, torch.bfloat16):
            P = torch.finfo(dtype).bits // 8
            x = torch.randn(w, n, generator=gen, device=dev).to(dtype)
            g = torch.randn(w, n, generator=gen, device=dev).to(dtype)
            m = (0.1 * torch.randn(w, n, generator=gen, device=dev)).to(dtype)
            lr = torch.full((), 0.05, dtype=torch.float32, device=dev)
            # K1
            want = ref.sgd_update(x, g, m, lr, **sgd_kw)
            got = ops.sgd_step(x.clone(), g, m.clone(), lr, **sgd_kw)
            oks = [_ulp_check(a, b, dtype) for a, b in zip(got, want)]
            del got, want
            rec = dict(kernel="K1 sgd_step", dtype=_name(dtype), shape=[w, n], max_abs_err=max(e for _, e in oks),
                       bound="bitwise" if dtype == torch.float32 else "1 bf16 ulp of plain", ok=all(o for o, _ in oks))
            worst["K1"] = max(worst["K1"], rec["max_abs_err"])
            if dtype == torch.float32:
                it = TIMING_ITERS[shape_name]
                rec["ms"] = time_ms(lambda: ops.sgd_step(x, g, m, lr, **sgd_kw), it)
                rec["plain_ms"] = time_ms(lambda: ref.sgd_update(x, g, m, lr, **sgd_kw), it)
                rec["library_ms"] = time_ms(lambda: torch._fused_sgd_(
                    [x], [g], [m], weight_decay=1e-4, momentum=0.9, lr=0.05, dampening=0.0, nesterov=True,
                    maximize=False, is_first_step=False), it)
                rec["bound_ms"], rec["bound_by"] = bound(5 * P * w * n, 8 * w * n)
                timing["K1"][shape_name] = rec
            log(json.dumps(rec))
            if not rec["ok"]:
                raise AssertionError(f"K1 sgd_step kernel disagrees with plain: {rec}")
            # K2 (moments f32, nu >= 0)
            mu = (0.1 * torch.randn(w, n, generator=gen, device=dev))
            nu = torch.rand(w, n, generator=gen, device=dev)
            c1 = torch.full((), 1 - 0.9**3, dtype=torch.float32, device=dev)
            c2 = torch.full((), 1 - 0.95**3, dtype=torch.float32, device=dev)
            want = ref.adamw_update(x, g, mu, nu, lr, c1, c2, **adam_kw)
            got = ops.adamw_step(x.clone(), g, mu.clone(), nu.clone(), lr, c1, c2, **adam_kw)
            oks = [_ulp_check(a, b, b.dtype) for a, b in zip(got, want)]
            del got, want
            rec = dict(kernel="K2 adamw_step", dtype=_name(dtype), shape=[w, n], max_abs_err=max(e for _, e in oks),
                       bound="bitwise" if dtype == torch.float32 else "1 bf16 ulp of plain (x); mu, nu bitwise",
                       ok=all(o for o, _ in oks))
            worst["K2"] = max(worst["K2"], rec["max_abs_err"])
            if dtype == torch.float32:
                it = TIMING_ITERS[shape_name]
                steps = [torch.full((), 3.0, device=dev)]
                rec["ms"] = time_ms(lambda: ops.adamw_step(x, g, mu, nu, lr, c1, c2, **adam_kw), it)
                rec["plain_ms"] = time_ms(lambda: ref.adamw_update(x, g, mu, nu, lr, c1, c2, **adam_kw), it)
                rec["library_ms"] = time_ms(lambda: torch._fused_adamw_(
                    [x], [g], [mu], [nu], [], steps, amsgrad=False, lr=0.05, beta1=0.9, beta2=0.95,
                    weight_decay=1e-4, eps=1e-8, maximize=False), it)
                rec["bound_ms"], rec["bound_by"] = bound((3 * P + 16) * w * n, 16 * w * n)
                timing["K2"][shape_name] = rec
            log(json.dumps(rec))
            if not rec["ok"]:
                raise AssertionError(f"K2 adamw_step kernel disagrees with plain: {rec}")
            del x, g, m, mu, nu
            _free()
    return worst, timing


def check_anchor_mix(dev, gen):
    """K5 anchor_mix, K3 pullback_mean_momentum and K4 pullback_mean against
    ref.py on the card: f32 and bf16; K3/K4 unmasked and masked (a dead
    row), K4 also mean_pre, at the slice's shape and unmasked on the large
    plane; K5 at both shapes (x and z both (m, n), as the gossip boundary
    gives it). Bound: bitwise — K5 rounds where its plain version rounds;
    K3/K4 also sum the worker axis in the same order (0 .. m-1, in f32).
    Times beside the plain version, a copy_ of the same bytes, K5 also beside
    torch.lerp_, and the bytes bound (K5 in f32 and bf16, K3/K4 in f32)."""
    import torch

    from repro_torch.kernels.anchor_mix import ops, ref

    alpha, beta = 0.6, 0.7
    worst = {"K3": 0.0, "K4": 0.0, "K5": 0.0}
    timing = {"K3": {}, "K4": {}, "K5": {}}
    for shape_name, (m, n) in TRAIN_SHAPES.items():
        for dtype in (torch.float32, torch.bfloat16):
            P = torch.finfo(dtype).bits // 8
            x = torch.randn(m, n, generator=gen, device=dev).to(dtype)
            z = torch.randn(n, generator=gen, device=dev).to(dtype)
            v = (0.1 * torch.randn(n, generator=gen, device=dev)).to(dtype)
            zx = torch.randn(m, n, generator=gen, device=dev).to(dtype)
            want = ref.anchor_mix(x, zx, alpha)
            got = ops.anchor_mix(x.clone(), zx, alpha)
            ok, err = bool(torch.equal(got, want)), float((got.float() - want.float()).abs().max())
            del got, want
            rec = dict(kernel="K5 anchor_mix", dtype=_name(dtype), shape=[m, n], max_abs_err=err,
                       bound="bitwise (same rounding points)", ok=ok)
            worst["K5"] = max(worst["K5"], err)
            it = TIMING_ITERS[shape_name]
            src = torch.empty(3 * m * n // 2, dtype=dtype, device=dev)
            dst = torch.empty_like(src)
            rec["ms"] = time_ms(lambda: ops.anchor_mix(x, zx, alpha), it)
            rec["plain_ms"] = time_ms(lambda: ref.anchor_mix(x, zx, alpha), it)
            rec["library_ms"] = time_ms(lambda: x.lerp_(zx, alpha), it)
            rec["copy_ms"] = time_ms(lambda: dst.copy_(src), it)
            rec["bound_ms"], rec["bound_by"] = bound(3 * P * m * n, 3 * m * n)
            rec["library"] = "torch.lerp_ (x + a (z - x)); copy_ moves the same 3 P m n bytes"
            timing["K5"][(shape_name, _name(dtype))] = rec
            del src, dst, zx
            log(json.dumps(rec))
            if not ok:
                raise AssertionError(f"K5 kernel disagrees with plain: {rec}")
            masks = [None]
            if shape_name == "slice":
                w = torch.full((m,), 1.0 / (m - 1), device=dev)
                w[1] = 0.0
                masks.append(w)
            for weights in masks:
                want = ref.pullback_mean_momentum(x, z, v, alpha, beta, weights=weights)
                got = ops.pullback_mean_momentum(x.clone(), z, v.clone(), alpha, beta, weights=weights)
                oks = [_ulp_check(a, b, torch.float32) for a, b in zip(got, want)]
                del got, want
                rec = dict(kernel="K3 pullback_mean_momentum", dtype=_name(dtype), shape=[m, n],
                           masked=weights is not None, max_abs_err=max(e for _, e in oks),
                           bound="bitwise (same worker-sum order)", ok=all(o for o, _ in oks))
                worst["K3"] = max(worst["K3"], rec["max_abs_err"])
                if dtype == torch.float32 and weights is None:
                    it = TIMING_ITERS[shape_name]
                    src = torch.empty(m * n + 2 * n, dtype=dtype, device=dev)
                    dst = torch.empty_like(src)
                    rec["ms"] = time_ms(lambda: ops.pullback_mean_momentum(x, z, v, alpha, beta), it)
                    rec["plain_ms"] = time_ms(lambda: ref.pullback_mean_momentum(x, z, v, alpha, beta), it)
                    rec["library_ms"] = time_ms(lambda: dst.copy_(src), it)
                    rec["bound_ms"], rec["bound_by"] = bound(2 * P * m * n + 4 * P * n, 4 * m * n + 5 * n)
                    timing["K3"][shape_name] = rec
                    del src, dst
                log(json.dumps(rec))
                if not rec["ok"]:
                    raise AssertionError(f"K3 kernel disagrees with plain: {rec}")
                for mean_pre in (False, True):
                    want = ref.pullback_mean(x, z, alpha, mean_pre=mean_pre, weights=weights)
                    got = ops.pullback_mean(x.clone(), z, alpha, mean_pre=mean_pre, weights=weights)
                    oks = [_ulp_check(a, b, torch.float32) for a, b in zip(got, want)]
                    del got, want
                    rec = dict(kernel="K4 pullback_mean", dtype=_name(dtype), shape=[m, n],
                               masked=weights is not None, mean_pre=mean_pre, max_abs_err=max(e for _, e in oks),
                               bound="bitwise (same worker-sum order)", ok=all(o for o, _ in oks))
                    worst["K4"] = max(worst["K4"], rec["max_abs_err"])
                    if dtype == torch.float32 and weights is None and not mean_pre:
                        it = TIMING_ITERS[shape_name]
                        src = torch.empty(m * n + n, dtype=dtype, device=dev)
                        dst = torch.empty_like(src)
                        rec["ms"] = time_ms(lambda: ops.pullback_mean(x, z, alpha), it)
                        rec["plain_ms"] = time_ms(lambda: ref.pullback_mean(x, z, alpha), it)
                        rec["library_ms"] = time_ms(lambda: dst.copy_(src), it)
                        rec["bound_ms"], rec["bound_by"] = bound(2 * P * m * n + 2 * P * n, 4 * m * n + n)
                        timing["K4"][shape_name] = rec
                        del src, dst
                    log(json.dumps(rec))
                    if not rec["ok"]:
                        raise AssertionError(f"K4 kernel disagrees with plain: {rec}")
            del x, z, v
            _free()
    return worst, timing


# ---------------------------------------------------------------------------
# phase 2 (c): the LM training kernels K6 (forward, dQ, dK/dV) and K7's backward
# ---------------------------------------------------------------------------

BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate, NVIDIA data sheet

# (name, B, Sq, Sk, H, Hkv, D, causal, window, q_offset, sk_valid): the LM
# slice's own shape (full-width qwen2-7b at seq 512), a ragged S with a padded
# K, a sliding window, a q_offset; and a long shape, timed where the
# operations bound the work
FA_CASES = [
    ("slice", 2, 512, 512, 28, 4, 128, True, None, 0, None),
    ("ragged", 1, 130, 160, 4, 2, 64, False, None, 0, 130),
    ("window", 2, 256, 256, 8, 2, 128, True, 64, 0, None),
    ("q_offset", 2, 64, 320, 8, 4, 64, True, None, 256, None),
]
FA_LONG = ("long", 1, 4096, 4096, 28, 4, 128, True, None, 0, None)
# stated bounds, as max|kernel - plain| / max|plain| (see the module docstring
# of repro_torch/kernels/flash_attention/ops.py): both sides compute in f32 and
# sum in other orders; in bf16 a value near a rounding boundary (of p before
# P.V, or of the output) may round either way
FA_BOUND = {"float32": {"out": 1e-5, "lse": 1e-5, "grad": 2e-5, "autograd": 1e-4},
            "bfloat16": {"out": 2.0**-7, "lse": 1e-5, "grad": 2.0**-7, "autograd": 2.0**-5}}


def _rel(got, want) -> float:
    return float((got.float() - want.float()).abs().max() / want.float().abs().max().clamp_min(1e-30))


def _fa_inputs(case, dtype, gen, dev):
    import torch

    _, b, sq, sk, h, hkv, d, *_ = case
    q = (torch.randn(b, sq, h, d, generator=gen, device=dev) / d**0.5).to(dtype)
    k = torch.randn(b, sk, hkv, d, generator=gen, device=dev).to(dtype)
    v = torch.randn(b, sk, hkv, d, generator=gen, device=dev).to(dtype)
    dout = torch.randn(b, sq, h, d, generator=gen, device=dev).to(dtype)
    return q, k, v, dout


def _fa_work(case, dtype):
    """(bytes, flops) of the forward, the dQ kernel and the dK/dV kernel for
    these inputs: each input read once, each output written once; the
    products over the (query, key) pairs the masks leave visible."""
    import torch

    from repro_torch.kernels.flash_attention import ref

    _, b, sq, sk, h, hkv, d, causal, window, q_offset, sk_valid = case
    pairs = int(ref.visible(sq, sk, causal=causal, window=window, q_offset=q_offset, sk_valid=sk_valid).sum())
    P = torch.finfo(dtype).bits // 8
    nq, nk, stats = b * sq * h * d * P, b * sk * hkv * d * P, b * h * sq * 4
    per = 2 * b * h * pairs * d  # one product over the visible pairs
    return {"fwd": (2 * nq + 2 * nk + stats, 2 * per),  # S = QK^T, O = PV
            "dq": (4 * nq + 2 * nk + 2 * stats, 3 * per),  # S, dP = dO V^T, dQ = dS K
            "dkdv": (2 * nq + 4 * nk + 2 * stats, 4 * per)}  # S, dP, dV = P^T dO, dK = dS^T Q


def check_flash_attention(dev, gen):
    """K6 forward and both backward kernels against their plain versions on
    the card (f32 and bf16), the backward also against torch autograd of the
    plain forward; times in bf16 beside the plain versions, SDPA with GQA
    expanded (forward; backward alone; forward + backward) and the bound."""
    import torch

    from repro_torch.kernels.flash_attention import ops, ref

    worst = {"fwd": 0.0, "dq": 0.0, "dkdv": 0.0}
    timing = {}
    for case in FA_CASES + [FA_LONG]:
        name, b, sq, sk, h, hkv, d, causal, window, q_offset, sk_valid = case
        kw = dict(causal=causal, window=window, q_offset=q_offset, sk_valid=sk_valid)
        for dtype in (torch.float32, torch.bfloat16) if name != "long" else (torch.bfloat16,):
            bnd = FA_BOUND[_name(dtype)]
            q, k, v, dout = _fa_inputs(case, dtype, gen, dev)
            out, lse = ops.flash_attention_fwd(q, k, v, **kw)
            out_p, lse_p = ref.flash_attention_fwd(q, k, v, **kw)
            fin = torch.isfinite(lse_p)
            lse_err = float(((lse - lse_p).abs() / lse_p.abs().clamp_min(1.0))[fin].max()) if fin.any() else 0.0
            lse_ok = lse_err <= bnd["lse"] and torch.equal(torch.isfinite(lse), fin)
            dq, delta = ops.flash_attention_bwd_dq(q, k, v, out, lse, dout, **kw)
            dk, dv = ops.flash_attention_bwd_dkdv(q, k, v, dout, lse, delta, **kw)
            dq_p, dk_p, dv_p = ref.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
            # the plain backward as torch autograd of the plain forward
            qa, ka, va = (t.detach().requires_grad_(True) for t in (q, k, v))
            ag = torch.autograd.grad(ref.flash_attention_fwd(qa, ka, va, **kw)[0], (qa, ka, va), dout)
            errs = dict(out=_rel(out, out_p), lse=lse_err, dq=_rel(dq, dq_p), dk=_rel(dk, dk_p), dv=_rel(dv, dv_p),
                        dq_autograd=_rel(dq, ag[0]), dk_autograd=_rel(dk, ag[1]), dv_autograd=_rel(dv, ag[2]))
            ok = (errs["out"] <= bnd["out"] and lse_ok and all(errs[g] <= bnd["grad"] for g in ("dq", "dk", "dv"))
                  and all(errs[g + "_autograd"] <= bnd["autograd"] for g in ("dq", "dk", "dv"))
                  and all(bool(torch.isfinite(t).all()) for t in (out, dq, dk, dv)))
            rec = dict(kernel="K6 flash_attention", case=name, dtype=_name(dtype), shape=[b, sq, sk, h, hkv, d],
                       causal=causal, window=window, q_offset=q_offset, sk_valid=sk_valid, rel_err=errs,
                       max_abs_err=dict(out=float((out.float() - out_p.float()).abs().max()),
                                        dq=float((dq.float() - dq_p.float()).abs().max()),
                                        dk=float((dk.float() - dk_p.float()).abs().max()),
                                        dv=float((dv.float() - dv_p.float()).abs().max())),
                       bound={k2: f"max|d|/max|plain| <= {v2}" for k2, v2 in bnd.items()}, ok=ok)
            worst["fwd"] = max(worst["fwd"], rec["max_abs_err"]["out"])
            worst["dq"] = max(worst["dq"], rec["max_abs_err"]["dq"])
            worst["dkdv"] = max(worst["dkdv"], rec["max_abs_err"]["dk"], rec["max_abs_err"]["dv"])
            if dtype == torch.bfloat16 and name in ("slice", "long"):
                rec["timing"] = timing[name] = _time_flash_attention(case, dtype, q, k, v, dout, out, lse, delta)
            log(json.dumps(rec))
            if not ok:
                raise AssertionError(f"K6 flash_attention kernels disagree with plain: {rec}")
            del q, k, v, dout, out, lse, out_p, lse_p, dq, dk, dv, dq_p, dk_p, dv_p, ag, qa, ka, va, delta
            _free()
    return worst, timing


def _time_flash_attention(case, dtype, q, k, v, dout, out, lse, delta):
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops, ref

    name, b, sq, sk, h, hkv, d, causal, window, q_offset, sk_valid = case
    kw = dict(causal=causal, window=window, q_offset=q_offset, sk_valid=sk_valid)
    it = 20 if name == "slice" else 3
    work = _fa_work(case, dtype)
    # the yardstick: SDPA on (B, H, S, D) with the kv-heads repeated for GQA
    g = h // hkv
    qe = q.transpose(1, 2).contiguous().requires_grad_(True)
    ke = k.repeat_interleave(g, dim=2).transpose(1, 2).contiguous().requires_grad_(True)
    ve = v.repeat_interleave(g, dim=2).transpose(1, 2).contiguous().requires_grad_(True)
    doe = dout.transpose(1, 2).contiguous()
    sdpa = lambda: F.scaled_dot_product_attention(qe, ke, ve, is_causal=causal, scale=1.0)
    oe = sdpa()
    t = {"sdpa_vs_plain_rel_err": _rel(oe.detach().transpose(1, 2), out)}
    t["fwd"] = dict(ms=time_ms(lambda: ops.flash_attention_fwd(q, k, v, **kw), it),
                    plain_ms=time_ms(lambda: ref.flash_attention_fwd(q, k, v, **kw), it),
                    library_ms=time_ms(sdpa, it))
    lib_bwd = time_ms(lambda: torch.autograd.grad(oe, (qe, ke, ve), doe, retain_graph=True), it)
    lib_fwd_bwd = time_ms(lambda: torch.autograd.grad(sdpa(), (qe, ke, ve), doe), it)
    t["dq"] = dict(ms=time_ms(lambda: ops.flash_attention_bwd_dq(q, k, v, out, lse, dout, **kw), it),
                   plain_ms=time_ms(lambda: ref.flash_attention_bwd_dq(q, k, v, out, lse, dout, **kw), it),
                   library_ms=lib_bwd, library_fwd_bwd_ms=lib_fwd_bwd)
    t["dkdv"] = dict(ms=time_ms(lambda: ops.flash_attention_bwd_dkdv(q, k, v, dout, lse, delta, **kw), it),
                     plain_ms=time_ms(lambda: ref.flash_attention_bwd_dkdv(q, k, v, dout, lse, delta, **kw), it),
                     library_ms=lib_bwd, library_fwd_bwd_ms=lib_fwd_bwd)
    rate = BF16_FLOPS if dtype == torch.bfloat16 else F32_FLOPS
    for part, (nbytes, flops) in work.items():
        t[part]["bound_ms"], t[part]["bound_by"] = bound(nbytes, flops, rate)
        t[part]["flops"], t[part]["bytes"] = flops, nbytes
        t[part]["flop_rate"] = "989 TFLOP/s dense bf16" if dtype == torch.bfloat16 else "67 TFLOP/s f32"
    t["library_note"] = "SDPA backward alone (autograd.grad with the graph kept) for both backward kernels"
    return t


RMS_BWD_ROWS = (7, 1024)  # a ragged row count, and the LM slice's rows (B*S = 2*512)


def check_rmsnorm_bwd(dev, gen):
    """K7 backward against torch autograd of the plain forward (f32, bf16);
    times at the LM slice's rows beside the plain version and F.rms_norm's
    autograd backward."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.rmsnorm import ops, ref

    d, eps, worst, timing = 3584, 1e-6, 0.0, None
    for dtype in (torch.bfloat16, torch.float32):
        for rows in RMS_BWD_ROWS:
            x = torch.randn(rows, d, generator=gen, device=dev).to(dtype)
            scale = (1 + 0.1 * torch.randn(d, generator=gen, device=dev)).to(dtype)
            dy = torch.randn(rows, d, generator=gen, device=dev).to(dtype)
            got = ops.rmsnorm_bwd(x, scale, dy, eps=eps)
            want = ref.rmsnorm_bwd(x, scale, dy, eps)
            again = ops.rmsnorm_bwd(x, scale, dy, eps=eps)
            ok, errs = all(torch.equal(a, b) for a, b in zip(got, again)), {}
            for nm, g, w in zip(("dx", "dscale"), got, want):
                err = (g.float() - w.float()).abs()
                slack = 1e-5 * w.float().abs().max()
                lim = slack + (bf16_ulp(w) if dtype == torch.bfloat16 else 0.0)
                ok &= bool((err <= lim).all())
                errs[nm] = float(err.max())
            stated = ("1 bf16 ulp of plain + 1e-5*max|plain|" if dtype == torch.bfloat16
                      else "1e-5*max|plain|")
            rec = dict(kernel="K7 rmsnorm_bwd", dtype=_name(dtype), rows=rows, d=d, max_abs_err=errs, bound=stated,
                       deterministic=True, ok=ok)
            if dtype == torch.bfloat16:
                worst = max(worst, *errs.values())
            if dtype == torch.bfloat16 and rows == 1024:
                xl, sl = x.detach().requires_grad_(True), scale.detach().requires_grad_(True)
                yl = F.rms_norm(xl, (d,), weight=sl, eps=eps)
                rec["ms"] = time_ms(lambda: ops.rmsnorm_bwd(x, scale, dy, eps=eps))
                rec["plain_ms"] = time_ms(lambda: ref.rmsnorm_bwd(x, scale, dy, eps))
                rec["library_ms"] = time_ms(lambda: torch.autograd.grad(yl, (xl, sl), dy, retain_graph=True))
                rec["bound_ms"], rec["bound_by"] = bound(3 * rows * d * 2 + 2 * d * 2, 10 * rows * d)
                timing = rec
            log(json.dumps(rec))
            if not ok:
                raise AssertionError(f"K7 rmsnorm_bwd kernel disagrees with plain (or is not deterministic): {rec}")
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
# phase 4: the training slice (the paper's classifier, Overlap-Local-SGD)
# ---------------------------------------------------------------------------

TRAIN_STEPS, SHORT_ROUNDS = 600, 20


def _experiment(dev, strategy, optimizer="sgd"):
    """examples/quickstart.py's configuration at its real width: 16 workers,
    the 30,000-sample task, batch 32 a worker, SGD lr 0.1 with Nesterov
    momentum 0.9, warmup_step_decay(0.1, 20, (300,)). AdamW runs at lr 1e-3
    on the same schedule shape."""
    from repro_torch.api import ClassificationSpec, Experiment
    from repro_torch.config import OptimizerConfig
    from repro_torch.optim import schedules

    lr = 0.1 if optimizer == "sgd" else 1e-3
    return Experiment(
        task=ClassificationSpec(n=30000, holdout=4000, batch_per_worker=32), strategy=strategy,
        optimizer=OptimizerConfig(name=optimizer, lr=lr, momentum=0.9, nesterov=True),
        schedule=schedules.warmup_step_decay(lr, 20, (TRAIN_STEPS // 2,)), workers=16, device=dev,
    )


def _fit(exp, kernels, rounds):
    """One run from zeroed counters: losses, wall time, launches, test_acc."""
    import torch

    exp.build()
    for k in kernels:
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = exp.fit(rounds=rounds)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in kernels}
    return dict(losses=res.losses, wall_s=wall, rounds_per_s=rounds / wall, steps=res.steps,
                launches=launches, test_acc=exp.evaluate()["test_acc"])


def train_slice(dev, kernels):
    import math

    import numpy as np
    import torch

    from repro_torch.config import AlgoConfig

    overlap = AlgoConfig(name="overlap_local_sgd", tau=2, alpha=0.6, anchor_beta=0.7)
    runs = {}

    def record(name, exp, rounds, expect):
        out = _fit(exp, kernels, rounds)
        buckets = exp.state.x.layout.num_buckets
        want = {k.name: 0 for k in kernels}
        want.update({k: v * buckets for k, v in expect.items()})
        if out["launches"] != want:
            raise AssertionError(f"{name}: launches {out['launches']} != {want}")
        if not all(math.isfinite(v) for v in out["losses"]):
            raise AssertionError(f"{name}: non-finite loss")
        out["buckets"] = buckets
        out["plane"] = [list(b.shape) for b in exp.state.x.buffers]
        log(json.dumps(dict(run=name, rounds=rounds, steps=out["steps"], wall_s=out["wall_s"],
                            rounds_per_s=out["rounds_per_s"], loss_every_30=out["losses"][::30],
                            final_loss=out["losses"][-1], test_acc=out["test_acc"], launches=out["launches"],
                            plane=out["plane"])))
        runs[name] = out
        return exp

    rounds = TRAIN_STEPS // overlap.tau
    # the main path: counts from zero, K1 once a step, K3 once a round (per bucket)
    exp = record("overlap_local_sgd", _experiment(dev, overlap), rounds,
                 {"sgd_step": TRAIN_STEPS, "pullback_momentum": rounds})
    plane = [b.clone() for b in exp.state.x.buffers]
    # replay: a second run of the same configuration gives the same losses and plane
    again = _experiment(dev, overlap)
    again.build()
    second = again.fit(rounds=rounds)
    if second.losses != runs["overlap_local_sgd"]["losses"]:
        raise AssertionError("overlap run is not deterministic: losses differ between two runs")
    if not all(torch.equal(a, b) for a, b in zip(plane, again.state.x.buffers)):
        raise AssertionError("overlap run is not deterministic: final planes differ")
    # the same configuration on the CPU (plain versions), from the same weights
    cpu = _experiment("cpu", overlap)
    cpu_losses = cpu.fit(rounds=SHORT_ROUNDS).losses
    card = np.asarray(runs["overlap_local_sgd"]["losses"][:SHORT_ROUNDS])
    rel = float(np.max(np.abs(card - np.asarray(cpu_losses)) / np.abs(np.asarray(cpu_losses))))
    # bound: rtol 1e-4 — f32 matmuls, tanh, exp and log in cuBLAS/CUDA vs the
    # CPU's libraries sum and round in other orders; 40 SGD steps carry those
    # differences forward without amplifying them past 1e-4 (the port matches
    # the JAX package to ~1e-7 on the CPU over the same number of rounds)
    if not rel <= 1e-4:
        raise AssertionError(f"card vs CPU losses over {SHORT_ROUNDS} rounds: max rel {rel} > 1e-4")
    log(json.dumps(dict(check="overlap card vs CPU plain", rounds=SHORT_ROUNDS, max_rel_err=rel,
                        bound="rtol 1e-4", deterministic_replay=True)))
    record("sync_sgd", _experiment(dev, AlgoConfig(name="sync_sgd", tau=1, alpha=0.0, anchor_beta=0.7)),
           TRAIN_STEPS, {"sgd_step": TRAIN_STEPS})
    record("overlap_adamw", _experiment(dev, overlap, "adamw"), SHORT_ROUNDS,
           {"adamw_step": 2 * SHORT_ROUNDS, "pullback_momentum": SHORT_ROUNDS})
    record("overlap_beta0", _experiment(dev, AlgoConfig(name="overlap_local_sgd", tau=2, alpha=0.6, anchor_beta=0.0)),
           SHORT_ROUNDS, {"sgd_step": 2 * SHORT_ROUNDS, "pullback_mean": SHORT_ROUNDS})
    profile = profile_train(_experiment(dev, overlap), SHORT_ROUNDS)
    log(json.dumps(dict(profile_overlap=profile)))
    return runs, profile


# the remaining strategies, 20 rounds each on the quickstart configuration:
# (run, AlgoConfig fields, launches a round per bucket, card-vs-CPU rtol).
# rtol 1e-4 as for the overlap run; sparse_anchor 1e-3: its top-k selection
# is discontinuous, so an element within an ulp of its leaf's threshold may
# be sent on one device and held back as error feedback on the other (the
# port against the JAX package on the CPU: 1.3e-4 after 20 rounds at k 0.25)
STRATEGY_RUNS = [
    ("gossip_ring", dict(name="gossip_ring"), {"sgd_step": 2, "anchor_mix": 1}, 1e-4),
    ("gossip_exp", dict(name="gossip_exp"), {"sgd_step": 2, "anchor_mix": 1}, 1e-4),
    ("gossip_full", dict(name="gossip_full"), {"sgd_step": 2, "pullback_mean": 1}, 1e-4),
    ("easgd", dict(name="easgd"), {"sgd_step": 2, "pullback_mean": 1}, 1e-4),
    ("cocod", dict(name="cocod"), {"sgd_step": 2}, 1e-4),
    ("delayed_avg", dict(name="delayed_avg", delay_steps=1), {"sgd_step": 2}, 1e-4),
    ("sparse_anchor", dict(name="sparse_anchor", sparse_k=0.25), {"sgd_step": 2, "pullback_mean": 1}, 1e-3),
    ("powersgd", dict(name="powersgd", powersgd_rank=2), {"sgd_step": 1}, 1e-4),
]


def train_strategies(dev, kernels):
    """Each of the remaining strategies on the quickstart configuration
    (tau 2, alpha 0.6; powersgd tau 1), 20 rounds from zeroed counters:
    exact launch counts, finite losses, the same losses and final plane on a
    second run, and the losses of the same run on the CPU (plain versions)
    within the run's stated rtol."""
    import math

    import numpy as np
    import torch

    from repro_torch.config import AlgoConfig

    runs = {}
    for name, fields, per_round, rtol in STRATEGY_RUNS:
        cfg = AlgoConfig(tau=2, alpha=0.6, **fields)
        exp = _experiment(dev, cfg)
        out = _fit(exp, kernels, SHORT_ROUNDS)
        buckets = exp.state.x.layout.num_buckets
        want = {k.name: 0 for k in kernels}
        want.update({k: v * SHORT_ROUNDS * buckets for k, v in per_round.items()})
        if out["launches"] != want:
            raise AssertionError(f"{name}: launches {out['launches']} != {want}")
        if not all(math.isfinite(v) for v in out["losses"]):
            raise AssertionError(f"{name}: non-finite loss {out['losses']}")
        again = _experiment(dev, cfg)
        again.build()
        if again.fit(rounds=SHORT_ROUNDS).losses != out["losses"]:
            raise AssertionError(f"{name} is not deterministic: losses differ between two runs")
        if not all(torch.equal(a, b) for a, b in zip(exp.state.x.buffers, again.state.x.buffers)):
            raise AssertionError(f"{name} is not deterministic: final planes differ")
        cpu = np.asarray(_experiment("cpu", cfg).fit(rounds=SHORT_ROUNDS).losses)
        rel = float(np.max(np.abs(np.asarray(out["losses"]) - cpu) / np.abs(cpu)))
        rec = dict(run=name, algo=fields, rounds=SHORT_ROUNDS, steps=out["steps"],
                   wall_s=out["wall_s"], rounds_per_s=out["rounds_per_s"], final_loss=out["losses"][-1],
                   test_acc=out["test_acc"], launches=out["launches"], deterministic_replay=True,
                   card_vs_cpu_max_rel=rel, bound=f"rtol {rtol}", ok=rel <= rtol)
        log(json.dumps(rec))
        if not rec["ok"]:
            raise AssertionError(f"{name}: card vs CPU losses over {SHORT_ROUNDS} rounds: max rel {rel} > {rtol}")
        runs[name] = rec
        del exp, again
    return runs


def profile_train(exp, rounds):
    """One overlap run under torch.profiler after a warm round: device busy
    time (sum of kernel times; one stream) against wall time, and aten ops
    and kernel launches per local step."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    exp.build()
    exp.fit(rounds=1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = exp.fit(rounds=rounds)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    averages = prof.key_averages()
    kern = [e for e in averages if e.device_type == DeviceType.CUDA]
    steps = res.steps
    if not kern:
        return dict(device_busy_us="not measured (no device events in the trace)", wall_us=wall_us)
    busy_us = sum(e.self_device_time_total for e in kern)
    aten = sum(e.count for e in averages if e.device_type == DeviceType.CPU and e.key.startswith("aten::"))
    launches = sum(e.count for e in kern)
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:10]
    host = sorted((e for e in averages if e.device_type == DeviceType.CPU), key=lambda e: -e.self_cpu_time_total)[:12]
    return dict(
        rounds=rounds, steps=steps, wall_us=wall_us, device_busy_us=busy_us, device_busy_share=busy_us / wall_us,
        aten_ops_per_step=aten / steps, kernel_launches_per_step=launches / steps, wall_us_per_step=wall_us / steps,
        top=[dict(name=e.key[:90], count=e.count, device_us=e.self_device_time_total) for e in top],
        top_host=[dict(name=e.key[:60], count=e.count, self_cpu_us=e.self_cpu_time_total) for e in host],
    )


# ---------------------------------------------------------------------------
# phase 5: the LM slice (qwen2-7b, Overlap-Local-SGD)
# ---------------------------------------------------------------------------

LM_ROUNDS, LM_WORKERS, LM_LAYERS = 3, 4, 2
LM_BATCH, LM_SEQ = 2, 512


def _lm_experiment(dev, cfg, workers, seq):
    """The training CLI's defaults: Overlap-Local-SGD tau 2, alpha 0.6, beta
    0.7, packed; SGD lr 1e-2 constant with Nesterov momentum 0.9."""
    from repro_torch.api import Experiment, TokenStream
    from repro_torch.config import AlgoConfig, OptimizerConfig
    from repro_torch.optim import schedules

    return Experiment(arch=cfg, strategy=AlgoConfig(name="overlap_local_sgd", tau=2, alpha=0.6, anchor_beta=0.7),
                      optimizer=OptimizerConfig(name="sgd", lr=1e-2, momentum=0.9, nesterov=True),
                      schedule=schedules.constant(1e-2), data=TokenStream(batch_per_worker=LM_BATCH, seq_len=seq),
                      workers=workers, device=dev)


def lm_card_vs_cpu(dev):
    """The reduced qwen2-7b with 2 KV heads (group 2), f32, seq 128, m = 2,
    3 rounds on the card (kernels) and on the CPU (plain versions), from the
    same weights. Bound: per-round losses rtol 1e-4 (f32 matmuls, exp and log
    on cuBLAS/CUDA and on the CPU sum and round in other orders; six SGD
    steps carry those differences without amplifying them past 1e-4)."""
    import numpy as np

    from repro_torch.config import get_arch

    base = get_arch("qwen2-7b").model.reduced()
    cfg = dataclasses.replace(base, attention=dataclasses.replace(base.attention, num_kv_heads=2))
    losses = {}
    for key, device in (("cuda", dev), ("cpu", "cpu")):
        losses[key] = np.asarray(_lm_experiment(device, cfg, 2, 128).fit(rounds=LM_ROUNDS).losses)
    rel = float(np.max(np.abs(losses["cuda"] - losses["cpu"]) / np.abs(losses["cpu"])))
    rec = dict(check="LM reduced qwen2-7b (group 2) f32, card kernels vs CPU plain", rounds=LM_ROUNDS,
               losses_card=losses["cuda"].tolist(), losses_cpu=losses["cpu"].tolist(), max_rel_err=rel,
               bound="rtol 1e-4", ok=rel <= 1e-4)
    log(json.dumps(rec))
    if not rec["ok"]:
        raise AssertionError(f"LM card vs CPU losses: max rel {rel} > 1e-4")


def _first_step_gradients(exp):
    """The gradient plane of the first local step (the first batch of the
    experiment's stream, from the built state): every leaf of every worker
    must have a non-zero gradient. Returns the leaves' count."""
    import torch

    from repro_torch.data import lm_batch_fn
    from repro_torch.models import transformer as T
    from repro_torch.parallel.packing import leaf_views
    from repro_torch.training.train_loop import gradient_plane

    first = lm_batch_fn(exp.model_cfg, exp.workers, LM_BATCH, exp.data.seq_len, seed=exp.data.seed)()
    pg, _ = gradient_plane(exp.loss_fn, exp.state.x, exp.to_device(first), per_worker=T.split_layers)
    m = exp.workers
    zero = [("/".join(p), int((~(v.reshape(m, -1) != 0).any(dim=1)).sum()))
            for p, v in zip(pg.layout.paths, leaf_views(pg))]
    zero = [z for z in zero if z[1]]
    del pg
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    if zero:
        raise AssertionError(f"leaves with an all-zero gradient in some worker (leaf, workers): {zero}")
    return len(exp.state.x.layout.paths)


def check_plane_scale(exp):
    """K1 and K3 on the full-width plane (4 x 1.556e9 bf16, 6.2e9 elements,
    offsets past 2^32): one launch each over the whole plane, then the last
    2^20 columns of every worker row against the plain version run on those
    columns alone (both kernels are elementwise across columns). Bound:
    bitwise, as at the smaller planes."""
    import torch

    from repro_torch.kernels.anchor_mix import ops as am_ops
    from repro_torch.kernels.anchor_mix import ref as am_ref
    from repro_torch.kernels.opt_step import ops as opt_ops
    from repro_torch.kernels.opt_step import ref as opt_ref

    t = 1 << 20
    x, mom = exp.state.x.buffers[0], exp.state.opt.momentum.buffers[0]
    z, v = exp.state.inflight.buffers[0], exp.state.vars.v.buffers[0]
    g = torch.empty_like(x).normal_(generator=torch.Generator(device=x.device).manual_seed(SEED))
    lr = torch.full((), 1e-2, dtype=torch.float32, device=x.device)
    kw = dict(momentum=0.9, nesterov=True, weight_decay=1e-4)
    want = opt_ref.sgd_update(x[:, -t:], g[:, -t:], mom[:, -t:], lr, **kw)
    opt_ops.sgd_step(x, g, mom, lr, **kw)
    k1 = torch.equal(x[:, -t:], want[0]) and torch.equal(mom[:, -t:], want[1])
    del g, want
    want = am_ref.pullback_mean_momentum(x[:, -t:], z[-t:], v[-t:], 0.6, 0.7)
    _, z_next, _ = am_ops.pullback_mean_momentum(x, z, v, 0.6, 0.7)
    k3 = torch.equal(x[:, -t:], want[0]) and torch.equal(z_next[-t:], want[1]) and torch.equal(v[-t:], want[2])
    rec = dict(check="K1 and K3 on the full-width plane", plane=list(x.shape), dtype=_name(x.dtype),
               columns_checked=t, bound="bitwise", k1_ok=k1, k3_ok=k3)
    log(json.dumps(rec))
    if not (k1 and k3):
        raise AssertionError(f"K1/K3 disagree with plain at the plane's end: {rec}")


def lm_full_width(dev, kernels):
    """Full-width qwen2-7b cut to 2 layers, bf16, m = 4 workers, seq 512,
    3 rounds (6 local steps) from zeroed counters: finite losses, exact launch
    counts, a non-zero gradient in every leaf, bitwise replay, a finite
    eval_loss; rounds/s, step ms, peak memory and one profiled round."""
    import gc
    import math

    import torch

    from repro_torch.config import get_arch

    cfg = dataclasses.replace(get_arch("qwen2-7b").model, num_layers=LM_LAYERS)
    t0 = time.perf_counter()
    exp = _lm_experiment(dev, cfg, LM_WORKERS, LM_SEQ).build()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    plane_shape, n_params = [list(b.shape) for b in exp.state.x.buffers], exp.num_params
    log(f"full-width {cfg.name} x{LM_LAYERS} layers: {n_params} params in {cfg.dtype}, plane {plane_shape}, "
        f"built in {build_s:.1f}s")
    n_leaves = _first_step_gradients(exp)

    for k in kernels:
        k.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = exp.fit(rounds=LM_ROUNDS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in kernels}
    peak = torch.cuda.max_memory_allocated()
    losses, steps = res.losses, res.steps
    del res  # it holds the final state
    m, L, buckets = LM_WORKERS, LM_LAYERS, exp.state.x.layout.num_buckets
    want = {k.name: 0 for k in kernels}
    want.update(flash_attention_fwd=steps * m * L, flash_attention_bwd_dq=steps * m * L,
                flash_attention_bwd_dkdv=steps * m * L, rmsnorm=steps * m * (2 * L + 1),
                rmsnorm_bwd=steps * m * (2 * L + 1), sgd_step=steps * buckets, pullback_momentum=LM_ROUNDS * buckets)
    if launches != want:
        raise AssertionError(f"LM launches {launches} != {want}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"LM losses not finite: {losses}")
    plane = [b.to("cpu", copy=True) for b in exp.state.x.buffers]
    evaluation = exp.evaluate()
    if not math.isfinite(evaluation["eval_loss"]):
        raise AssertionError(f"eval_loss not finite: {evaluation}")
    profile = profile_train(exp, 1)
    del exp
    gc.collect()
    torch.cuda.empty_cache()

    again = _lm_experiment(dev, cfg, LM_WORKERS, LM_SEQ).build()
    second = again.fit(rounds=LM_ROUNDS).losses
    if second != losses:
        raise AssertionError(f"LM run is not deterministic: losses {losses} vs {second}")
    if not all(torch.equal(a, b.cpu()) for a, b in zip(plane, again.state.x.buffers)):
        raise AssertionError("LM run is not deterministic: final planes differ")
    del plane
    check_plane_scale(again)
    del again
    gc.collect()
    torch.cuda.empty_cache()
    summary = dict(
        slice=f"{cfg.name} full width, {L} layers, {cfg.dtype}", params=n_params,
        workers=m, batch_per_worker=LM_BATCH, seq_len=LM_SEQ, rounds=LM_ROUNDS, steps=steps, plane=plane_shape,
        leaves=n_leaves, build_s=build_s, wall_s=wall, rounds_per_s=LM_ROUNDS / wall, step_ms=wall / steps * 1e3,
        losses=losses, eval_loss=evaluation["eval_loss"], peak_mem_bytes=peak, launches=launches,
        nonzero_grad_every_leaf=True, deterministic_replay=True, profile=profile,
    )
    log(json.dumps(summary))
    return summary


def lm_gossip_full_width(dev, kernels):
    """This slice's path: full-width qwen2-7b cut to 2 layers, bf16, m = 4,
    seq 512, SGD as the LM phase, trained with gossip_ring (tau 2, alpha
    0.6) for 3 rounds from zeroed counters: exact launch counts (K5 once a
    boundary, K3 and K4 never), finite losses, the same losses and final
    plane on a second run, K5 bitwise against its plain version at the last
    2^20 columns of every row of the plane (offsets past 2^32); rounds/s,
    step ms, peak memory and one profiled round."""
    import gc
    import math

    import torch

    from repro_torch.api import Experiment, TokenStream
    from repro_torch.config import AlgoConfig, OptimizerConfig, get_arch
    from repro_torch.kernels.anchor_mix import ops as am_ops
    from repro_torch.kernels.anchor_mix import ref as am_ref
    from repro_torch.optim import schedules

    cfg = dataclasses.replace(get_arch("qwen2-7b").model, num_layers=LM_LAYERS)

    def experiment():
        return Experiment(arch=cfg, strategy=AlgoConfig(name="gossip_ring", tau=2, alpha=0.6),
                          optimizer=OptimizerConfig(name="sgd", lr=1e-2, momentum=0.9, nesterov=True),
                          schedule=schedules.constant(1e-2), data=TokenStream(batch_per_worker=LM_BATCH, seq_len=LM_SEQ),
                          workers=LM_WORKERS, device=dev).build()

    t0 = time.perf_counter()
    exp = experiment()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    for k in kernels:
        k.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = exp.fit(rounds=LM_ROUNDS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in kernels}
    peak = torch.cuda.max_memory_allocated()
    losses, steps = res.losses, res.steps
    del res
    m, L, buckets = LM_WORKERS, LM_LAYERS, exp.state.x.layout.num_buckets
    want = {k.name: 0 for k in kernels}
    want.update(flash_attention_fwd=steps * m * L, flash_attention_bwd_dq=steps * m * L,
                flash_attention_bwd_dkdv=steps * m * L, rmsnorm=steps * m * (2 * L + 1),
                rmsnorm_bwd=steps * m * (2 * L + 1), sgd_step=steps * buckets, anchor_mix=LM_ROUNDS * buckets)
    if launches != want:
        raise AssertionError(f"LM gossip launches {launches} != {want}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"LM gossip losses not finite: {losses}")
    plane = [b.to("cpu", copy=True) for b in exp.state.x.buffers]
    profile = profile_train(exp, 1)
    del exp
    gc.collect()
    torch.cuda.empty_cache()

    again = experiment()
    second = again.fit(rounds=LM_ROUNDS).losses
    if second != losses:
        raise AssertionError(f"LM gossip run is not deterministic: losses {losses} vs {second}")
    if not all(torch.equal(a, b.cpu()) for a, b in zip(plane, again.state.x.buffers)):
        raise AssertionError("LM gossip run is not deterministic: final planes differ")
    del plane
    # K5 over the whole plane, toward the in-flight mix; the last 2^20 columns
    # of every row against the plain version on those columns alone
    t = 1 << 20
    x, z = again.state.x.buffers[0], again.state.inflight.mix.buffers[0]
    ref_end = am_ref.anchor_mix(x[:, -t:], z[:, -t:], 0.6)
    am_ops.anchor_mix(x, z, 0.6)
    k5_ok = bool(torch.equal(x[:, -t:], ref_end))
    log(json.dumps(dict(check="K5 on the full-width gossip plane", plane=list(x.shape), dtype=_name(x.dtype),
                        columns_checked=t, bound="bitwise", ok=k5_ok)))
    if not k5_ok:
        raise AssertionError("K5 disagrees with plain at the end of the full-width plane")
    del again, x, z, ref_end
    gc.collect()
    torch.cuda.empty_cache()
    summary = dict(
        slice=f"{cfg.name} full width, {L} layers, {cfg.dtype}, gossip_ring", workers=m, batch_per_worker=LM_BATCH,
        seq_len=LM_SEQ, rounds=LM_ROUNDS, steps=steps, build_s=build_s, wall_s=wall, rounds_per_s=LM_ROUNDS / wall,
        step_ms=wall / steps * 1e3, losses=losses, peak_mem_bytes=peak, launches=launches,
        deterministic_replay=True, profile=profile,
    )
    log(json.dumps(summary))
    return summary


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
    opt_err, opt_t = check_opt_step(dev, gen)
    mix_err, mix_t = check_anchor_mix(dev, gen)
    fa_err, fa_t = check_flash_attention(dev, gen)
    rb_err, rb_t = check_rmsnorm_bwd(dev, gen)

    # phases 3, 4 and 5: serving, classifier training, LM training
    serving = [k for k in kernels if k.name in ("rmsnorm", "paged_attend", "paged_append")]
    check_small_model_against_cpu(dev)
    summary = serve_full_width(dev, serving)
    summary["card"] = card
    log(json.dumps(summary))
    runs, _ = train_slice(dev, kernels)
    runs.update(train_strategies(dev, kernels))
    lm_card_vs_cpu(dev)
    lm = lm_full_width(dev, kernels)
    lm["card"] = card
    gossip = lm_gossip_full_width(dev, kernels)
    gossip["card"] = card

    # phase 6
    launches = dict(summary["launches"])
    launches["sgd_step"] = runs["overlap_local_sgd"]["launches"]["sgd_step"]
    launches["pullback_momentum"] = runs["overlap_local_sgd"]["launches"]["pullback_momentum"]
    launches["adamw_step"] = runs["overlap_adamw"]["launches"]["adamw_step"]
    launches["pullback_mean"] = runs["overlap_beta0"]["launches"]["pullback_mean"]
    for name in ("flash_attention_fwd", "flash_attention_bwd_dq", "flash_attention_bwd_dkdv", "rmsnorm_bwd"):
        launches[name] = lm["launches"][name]
    # kernels on several paths: every path's count (K7's row keeps the serving run's)
    by_path = {k.name: {"serving": summary["launches"].get(k.name, 0),
                        "classifier": runs["overlap_local_sgd"]["launches"].get(k.name, 0),
                        "lm": lm["launches"][k.name]} for k in kernels}
    fa_slice = "bf16 B=2 S=512 H=28 Hkv=4 D=128 causal (the LM slice)"
    rows = [
        ("rmsnorm", "rmsnorm", "K7 rmsnorm_2d", "src/repro/kernels/rmsnorm/kernel.py:26", rms_err, rms_t[4],
         "bf16 rows=4 d=3584 (decode)", None),
        ("paged_attend", "paged_attend", "K9 paged_attend_decode", "src/repro/kernels/paged_attn/kernel.py:89",
         att_err, att_t, "bf16 S=4 KV=4 G=7 D=128 page=16 maxp=32 lengths 0/17/300/511", None),
        ("paged_append", "paged_append", "K10 paged_append_decode", "src/repro/kernels/paged_attn/kernel.py:145",
         app_err, app_t[1], "bf16 S=4 T=1 KV=4 D=128 (decode)", None),
        ("sgd_step", "opt_step", "K1 sgd_step_flat", "src/repro/kernels/opt_step/kernel.py:48", opt_err["K1"],
         opt_t["K1"]["slice"], "f32 w=16 n=17408 (the classifier plane)", opt_t["K1"]["large"]),
        ("adamw_step", "opt_step", "K2 adamw_step_flat", "src/repro/kernels/opt_step/kernel.py:81", opt_err["K2"],
         opt_t["K2"]["slice"], "f32 w=16 n=17408 (the classifier plane)", opt_t["K2"]["large"]),
        ("pullback_momentum", "anchor_mix", "K3 pullback_momentum_flat", "src/repro/kernels/anchor_mix/kernel.py:190",
         mix_err["K3"], mix_t["K3"]["slice"], "f32 m=16 n=17408 (the classifier plane)", mix_t["K3"]["large"]),
        ("pullback_mean", "anchor_mix", "K4 pullback_mean_flat", "src/repro/kernels/anchor_mix/kernel.py:120",
         mix_err["K4"], mix_t["K4"]["slice"], "f32 m=16 n=17408 (the classifier plane)", mix_t["K4"]["large"]),
        ("flash_attention_fwd", "flash_attention", "K6 flash_attention_bhsd (forward)",
         "src/repro/kernels/flash_attention/kernel.py:83", fa_err["fwd"], fa_t["slice"]["fwd"], fa_slice,
         dict(shape="bf16 B=1 S=4096 H=28 Hkv=4 D=128 causal", **fa_t["long"]["fwd"])),
        ("flash_attention_bwd_dq", "flash_attention", "K6 backward, dQ kernel (new; no TPU kernel)",
         "src/repro/kernels/flash_attention/ops.py:76", fa_err["dq"], fa_t["slice"]["dq"], fa_slice,
         dict(shape="bf16 B=1 S=4096 H=28 Hkv=4 D=128 causal", **fa_t["long"]["dq"])),
        ("flash_attention_bwd_dkdv", "flash_attention", "K6 backward, dK/dV kernel (new; no TPU kernel)",
         "src/repro/kernels/flash_attention/ops.py:76", fa_err["dkdv"], fa_t["slice"]["dkdv"], fa_slice,
         dict(shape="bf16 B=1 S=4096 H=28 Hkv=4 D=128 causal", **fa_t["long"]["dkdv"])),
        ("rmsnorm_bwd", "rmsnorm", "K7 backward (new; the reference has none)", "src/repro/kernels/rmsnorm/ops.py:11",
         rb_err, rb_t, "bf16 rows=1024 d=3584 (the LM slice)", None),
    ]
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    k5 = mix_t["K5"]
    rows.insert(7, ("anchor_mix", "anchor_mix", "K5 anchor_mix_flat", "src/repro/kernels/anchor_mix/kernel.py:51",
                    mix_err["K5"], k5[("slice", "float32")], "f32 m=16 n=17408 (the classifier's gossip plane)",
                    k5[("large", "float32")]))
    launches["anchor_mix"] = gossip["launches"]["anchor_mix"]
    by_path["anchor_mix"] = {"classifier gossip_ring": runs["gossip_ring"]["launches"]["anchor_mix"],
                             "classifier gossip_exp": runs["gossip_exp"]["launches"]["anchor_mix"],
                             "lm gossip_ring": gossip["launches"]["anchor_mix"]}
    out = []
    for name, source, label, replaces, err, t, shape, large in rows:
        entry = dict(
            name=label, route="cuda", source=f"src/repro_torch/csrc/{source}.cu", replaces=replaces,
            launches=launches[name], max_abs_err=err, **{k: t[k] for k in keys}, shape=shape, status="ok", card=card,
        )
        if "library_fwd_bwd_ms" in t:  # K6's backward: SDPA forward + backward too
            entry["library_fwd_bwd_ms"] = t["library_fwd_bwd_ms"]
        if large is not None:
            entry["large"] = dict(shape=large["shape"], **{k: large[k] for k in keys})
        if name == "anchor_mix":
            entry["launches_by_path"] = by_path[name]
            entry["copy_ms"], entry["large"]["copy_ms"] = t["copy_ms"], large["copy_ms"]
            entry["bf16"] = {sh: {k: k5[(sh, "bfloat16")][k] for k in keys + ("copy_ms",)} for sh in ("slice", "large")}
            entry["library"] = t["library"]
        elif any(by_path[name][p] for p in ("serving", "classifier")) and any(by_path[name][p] for p in ("lm",)):
            entry["launches_by_path"] = by_path[name]
        out.append(entry)
    out[0]["train"] = dict(shape="bf16 rows=1024 d=3584 (the LM slice)", **{k: rms_t[1024][k] for k in keys})
    log(json.dumps({"kernels": out}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
