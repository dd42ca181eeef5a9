"""Serving launcher: batched generation with the reduced (or full) config.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-7b --full
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-7b --full
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-1.2b --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-v3-671b --full --layers 4

Weights are random, drawn from a seeded ``torch.Generator`` on the device.
The GQA archs (arctic-480b's MoE among them) and deepseek-v3-671b (MLA's
latent pools) are served paged; rwkv6-7b and zamba2-1.2b by the dense
fallback (one request at a time through ``generate``). ``--layers N`` cuts
the config to its first N layers (deepseek-v3-671b's 671 G parameters do not
fit one card). qwen2-vl-7b serves text requests by the dense fallback (its
image path is ``prefill`` with ``image_embeds``, then ``decode_step``);
musicgen-large has no engine, and the launcher raises for it as the
engine does. Runs on the GPU unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.config import get_arch, list_archs
from repro_torch.launch import cut
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
    ap.add_argument("--layers", type=int, default=None, help="cut the model to its first N layers")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    arch = get_arch(args.arch)
    cfg = cut(arch.model if args.full else arch.model.reduced(), args.layers)
    if cfg.frontend is not None:
        print("note: the serving launcher serves text requests; a frontend's own inputs (image embeddings, "
              "codebook tokens) go through prefill and decode_step")
    device = resolve_device(args.device)
    gen = torch.Generator(device=device).manual_seed(0)
    params = T.init_model(cfg, gen, device=device)
    eng = BatchedEngine(cfg, params, slots=args.slots, page_size=args.page_size, device=device)
    kind = f"paged (page_size={eng.page_size}, pool={eng.num_pages} pages)" if eng.paged else "dense fallback"
    print(f"engine: {kind} on {device}")
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
