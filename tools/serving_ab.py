#!/usr/bin/env python3
"""Serving A/B on one GPU: full-width qwen2-7b through each checkout's own
``chip_smoke.serve_full_width``, one fresh process per run, in the order given.

    python3 tools/serving_ab.py ROOT_A ROOT_B ROOT_B ROOT_A
    python3 tools/serving_ab.py --zamba2 ROOT_A ROOT_B ROOT_B ROOT_A
    python3 tools/serving_ab.py --rwkv6 ROOT_A ROOT_B ROOT_B ROOT_A
    python3 tools/serving_ab.py --qwen2 ROOT_A ROOT_B ROOT_B ROOT_A

Each ROOT is a checkout of the repository (for example the parent commit
unpacked with ``git archive`` into a directory that ``.gitignore`` lists). A
run builds that checkout's kernels into its own ``build/kernels/``, serves the
seeded 8-request trace three times (plain, timed, profiled) with that
checkout's launch-count and replay checks, and prints one JSON line: the
root, tok/s, the median decode-step and prefill-chunk ms, the device busy
share of the profiled run, the launch counts and the card's ``nvidia-smi``
name and power limit. With ``--zamba2`` (``--rwkv6``, ``--qwen2``) a run
trains full-width zamba2-1.2b at 38 layers (rwkv6-7b at 4, qwen2-7b at 2
with Overlap-Local-SGD) instead, through the checkout's
``chip_smoke.lm_zamba2_full_width`` (``lm_rwkv6_full_width``,
``lm_full_width``): m = 4, 3 rounds, the checkout's own checks; it prints the step ms, rounds/s,
peak memory and device busy share of the LM paths a shared host sets. A run
that fails stops the script with its exit code.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

RUN = r"""
import json, subprocess, sys
root = sys.argv[1]
sys.path.insert(0, root + "/src")
sys.path.insert(0, root)
import torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
import chip_smoke
from repro_torch.kernels import _build, all_kernels
kernels = all_kernels()
_build.build_all(kernels)
card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                      capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
if sys.argv[2] in ("zamba2", "rwkv6"):
    s = getattr(chip_smoke, f"lm_{sys.argv[2]}_full_width")(torch.device("cuda", 0), kernels)
    keys = ("step_ms", "rounds_per_s", "wall_s", "peak_mem_bytes", "launches")
elif sys.argv[2] == "qwen2":
    import dataclasses
    from repro_torch.config import get_arch
    cfg = dataclasses.replace(get_arch("qwen2-7b").model, num_layers=chip_smoke.LM_LAYERS)
    s = chip_smoke.lm_full_width(torch.device("cuda", 0), kernels, cfg, shares=chip_smoke.K6_SHARES)
    keys = ("step_ms", "rounds_per_s", "wall_s", "peak_mem_bytes", "launches")
else:
    serving = [k for k in kernels if k.name in ("rmsnorm", "paged_attend", "paged_append")]
    s = chip_smoke.serve_full_width(torch.device("cuda", 0), serving)
    keys = ("tok_s", "decode_step_ms_median", "prefill_chunk_ms_median", "wall_s", "decode_forwards",
            "prefill_forwards", "launches")
out = {k: s[k] for k in keys}
out["device_busy_share"] = s["profile"].get("device_busy_share")
print(json.dumps(dict(root=root, card=card, **out)), flush=True)
"""


def main() -> int:
    roots = sys.argv[1:]
    path = "serving"
    if roots[:1] in (["--zamba2"], ["--rwkv6"], ["--qwen2"]):
        path, roots = roots[0][2:], roots[1:]
    if not roots:
        print(__doc__, file=sys.stderr)
        return 2
    for root in roots:
        if not (Path(root) / "chip_smoke.py").is_file():
            print(f"serving_ab: {root} holds no chip_smoke.py", file=sys.stderr)
            return 2
    for root in roots:
        proc = subprocess.run([sys.executable, "-c", RUN, str(Path(root).resolve()), path], capture_output=True,
                              text=True)
        lines = proc.stdout.strip().splitlines()
        if proc.returncode != 0 or not lines:
            print(proc.stdout[-4000:], proc.stderr[-4000:], sep="\n", file=sys.stderr)
            return proc.returncode or 1
        print(lines[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
