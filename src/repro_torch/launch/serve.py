"""Serving launcher: batched generation with the reduced (or full) config.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-7b --full
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-7b --device cpu

Weights are random, drawn from a seeded ``torch.Generator`` on the device.
Runs on the GPU unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.config import get_arch, list_archs
from repro_torch.models import transformer as T
from repro_torch.serving import BatchedEngine, resolve_device


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list_archs())
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    arch = get_arch(args.arch)
    cfg = arch.model if args.full else arch.model.reduced()
    device = resolve_device(args.device)
    gen = torch.Generator(device=device).manual_seed(0)
    params = T.init_model(cfg, gen, device=device)
    eng = BatchedEngine(cfg, params, slots=args.slots, page_size=args.page_size, device=device)
    print(f"engine: paged (page_size={eng.page_size}, pool={eng.num_pages} pages) on {device}")
    rng = np.random.default_rng(0)
    for i in range(args.requests):
        eng.submit(f"req-{i}", rng.integers(0, cfg.vocab_size, (4 + i % 5,)).astype(np.int32), args.max_new)
    t0 = time.time()
    results = eng.run()
    dt = time.time() - t0
    total = sum(len(v) for v in results.values())
    print(f"served {len(results)} requests / {total} tokens in {dt:.1f}s ({total/dt:.1f} tok/s)")
    for rid in sorted(results):
        print(f"  {rid}: {results[rid].tolist()}")


if __name__ == "__main__":
    main()
