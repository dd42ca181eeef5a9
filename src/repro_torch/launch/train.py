"""Training launcher — a thin CLI over :class:`repro_torch.api.Experiment`
(counterpart of ``repro.launch.train``, with the same flags plus
``--device``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-7b --rounds 20 \
        [--algo overlap_local_sgd] [--tau 2] [--alpha 0.6] [--workers 4] [--full]
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-7b --rounds 3 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-1.2b --full --rounds 3 --seq 512
    PYTHONPATH=src python -m repro_torch.launch.train --arch deepseek-v3-671b --full --layers 1 --workers 2 --seq 512

``--arch`` takes every arch of the reference (qwen2-7b, h2o-danube-1.8b,
mistral-large-123b, command-r-35b, arctic-480b, deepseek-v3-671b,
rwkv6-7b, zamba2-1.2b, qwen2-vl-7b with its image batches, musicgen-large
on codebook tokens), reduced unless ``--full`` is given; ``--layers N``
cuts the config to its first N layers (the published widths at a depth one
card holds). Runs on the GPU unless ``--device cpu`` is given. ``--algo`` takes every
strategy of the reference and its aliases (``dasgd``, ``loscar``,
``overlap``, ``sgp``); ``--ckpt PATH`` saves the final ``TrainState`` there
(:mod:`repro_torch.checkpoint`, the reference's .npz format).
"""
from __future__ import annotations

import argparse
import time

from repro_torch import checkpoint
from repro_torch.api import Experiment, TokenStream
from repro_torch.config import AlgoConfig, OptimizerConfig, get_arch, list_archs
from repro_torch.core import STRATEGIES
from repro_torch.core.strategy import _ALIASES
from repro_torch.launch import cut
from repro_torch.optim import schedules


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list_archs())
    ap.add_argument("--algo", default="overlap_local_sgd", choices=sorted(STRATEGIES) + sorted(_ALIASES))
    ap.add_argument("--tau", type=int, default=2)
    ap.add_argument("--alpha", type=float, default=0.6)
    ap.add_argument("--anchor-beta", type=float, default=0.7)
    ap.add_argument("--delay-steps", type=int, default=1, help="delayed_avg: consume k steps into the round")
    ap.add_argument("--sparse-k", type=float, default=1.0, help="sparse_anchor: top-k fraction transmitted")
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-2)
    ap.add_argument("--full", action="store_true", help="use the full (not reduced) model config")
    ap.add_argument("--layers", type=int, default=None, help="cut the model to its first N layers")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    model = get_arch(args.arch).model
    exp = Experiment(
        arch=cut(model if args.full else model.reduced(), args.layers),
        strategy=AlgoConfig(
            name=args.algo,
            tau=args.tau,
            alpha=args.alpha,
            anchor_beta=args.anchor_beta,
            delay_steps=args.delay_steps,
            sparse_k=args.sparse_k,
        ),
        optimizer=OptimizerConfig(name="sgd", lr=args.lr, momentum=0.9, nesterov=True),
        schedule=schedules.constant(args.lr),
        data=TokenStream(batch_per_worker=args.batch, seq_len=args.seq),
        workers=args.workers,
        rounds=args.rounds,
        device=args.device,
    )
    exp.build()
    print(
        f"{exp.model_cfg.name}: {exp.num_params/1e6:.1f}M params | "
        f"{args.algo} tau={exp.tau} alpha={args.alpha} m={args.workers} on {exp.dev}"
    )

    t0 = time.time()
    every = max(1, args.rounds // 10)

    def log(r, loss):
        if r % every == 0 or r == args.rounds - 1:
            print(f"round {r:4d}  loss {loss:.4f}  ({time.time()-t0:.0f}s)")

    exp.fit(log=log)
    if args.ckpt:
        checkpoint.save(args.ckpt, exp.state)
        print(f"checkpoint -> {args.ckpt}")


if __name__ == "__main__":
    main()
