#!/usr/bin/env python3
"""Offloaded musicgen-large on one GPU, the stacked run against the rank run
in one process: ``chip_smoke.musicgen_offload`` (phase 9(d, e): m 2
offloaded and resident, then the stacked m 4 offloaded run and its digests),
``chip_smoke.rank_nccl_musicgen_offload`` (phase 14(b): m 4 offloaded on one
NCCL rank holding every row, bit for bit the stacked run) twice, and the
stacked m 4 run again: stacked, rank, rank, stacked.

    python3 tools/offload_rank_ab.py

Run from the root of a checkout on a machine with one card. Each run prints
chip_smoke's JSON record with its step split (the streamed update's and the
gradient's device and host ms, ``_StepSplit``) and the machine's readings
(SM clock, power, CPU seconds, ``_Conditions``); between runs a line with
the host's MemAvailable and the pinned allocator's stats, and last the four
step ms in order beside the card's ``nvidia-smi`` name and power limit. A
failed bitwise check stops the script with the exception.
"""
from __future__ import annotations

import gc
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import _build, all_kernels

    if not torch.cuda.is_available():
        print("offload_rank_ab: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    kernels = all_kernels()
    t0 = time.perf_counter()
    _build.build_all(kernels)
    print("build", time.perf_counter() - t0, flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    _, win_t = cs.check_opt_windows(dev, gen)
    window_ms = win_t["K1"]["large_bf16"]["ms"]
    host_stats = getattr(torch.cuda, "host_memory_stats", None)

    def host_memory(when):
        rec = dict(when=when, host=cs._meminfo())
        if host_stats is not None:
            try:
                rec["pinned"] = {k: v for k, v in host_stats().items() if "bytes" in k or "alloc" in k.lower()}
            except Exception as e:  # the allocator's stats are a reading only
                rec["pinned_err"] = repr(e)[:200]
        print(json.dumps(rec), flush=True)

    host_memory("start")
    mg = cs.musicgen_offload(dev, kernels, card)
    m4 = mg["m4_offloaded"]
    stacked = dict(m4, digests=mg["m4_digests"])
    print(json.dumps(dict(stacked_m4=dict(step_ms=m4["step_ms"], round_ms=m4["round_ms"], split=m4.get("step_split"),
                                          cond=m4.get("conditions")))), flush=True)
    host_memory("after 9(d, e)")
    rank = []
    for i in range(2):
        rank.append(cs.rank_nccl_musicgen_offload(dev, kernels, card, stacked, window_ms)["step_ms"])
        host_memory(f"after 14(b) #{i}")
    again, exp = cs.train_musicgen_offloaded(dev, kernels, 4, True)
    del exp
    gc.collect()
    cs._free()
    host_memory("after stacked again")
    print(json.dumps(dict(order="stacked, rank, rank, stacked", step_ms=[m4["step_ms"], *rank, again["step_ms"]],
                          card=card)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
