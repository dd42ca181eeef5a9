"""The port's (worker, fsdp) mesh against the JAX package's mesh: two
rounds of the reduced qwen2-7b, Overlap-Local-SGD β 0.7 on the packed
plane (τ 2, SGD at lr 1e-2, m 2), on the reference's host mesh
``make_smoke_mesh(2, 2, 1)`` (four XLA host devices, in a subprocess that
sets ``XLA_FLAGS=--xla_force_host_platform_device_count=4`` before it
imports JAX) and on four gloo ranks of the port, (W, F) = (2, 2), from the
same numpy params and batches (the reference's draw).

The reference shards the same state the same way (the worker-stacked
plane over ``("worker", "fsdp")``, the anchor over every axis) and lets
XLA place the collectives; the port gathers each worker's row, takes the
gradient of its half batch and reduce-scatters it. Bound: the port's
stacked rounds against JAX's on this LM (``tests/test_torch_dist.py``):
f32 x, z, v and the in-flight anchor within rtol 1e-5, atol 1e-6, the
momentum within 1e-5 of its largest magnitude, the losses within rtol
1e-5. (The reference's own packed-vs-per-leaf check on its 8-device mesh,
``tests/test_dryrun_small.py``, holds 2e-7: two programs of one package.)
"""
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_dist_ranks as ranks

SRC = str(Path(__file__).resolve().parents[1] / "src")
_TIMEOUT = int(os.environ.get("REPRO_SUBPROC_TIMEOUT", "300"))
LR, ROUNDS = 1e-2, 2

REFERENCE = r"""
import os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from repro.config import AlgoConfig, OptimizerConfig, get_arch
from repro.core import make_strategy
from repro.launch.mesh import make_smoke_mesh
from repro.models import transformer as T
from repro.optim import from_config, schedules
from repro.parallel import mesh_context
from repro.training import make_round_step, make_train_state

LR, ROUNDS = %r, %r
mesh = make_smoke_mesh(2, 2, 1)
cfg = get_arch("qwen2-7b").model.reduced()
opt = from_config(OptimizerConfig(name="sgd", lr=LR))
rng = np.random.default_rng(0)
batches = [dict(tokens=rng.integers(0, cfg.vocab_size, (2, 2, 4, 32)).astype(np.int32),
                targets=rng.integers(0, cfg.vocab_size, (2, 2, 4, 32)).astype(np.int32)) for _ in range(ROUNDS)]
planes = lambda p: [np.asarray(b.astype(jnp.float32)) for b in p.buffers]
out = dict(batches=batches, loss=[], x=[])
with mesh_context(mesh):
    params, axes = T.init_model(cfg, jax.random.PRNGKey(0))
    strat = make_strategy(AlgoConfig(name="overlap_local_sgd", tau=2, anchor_beta=0.7, packed=True))
    state = make_train_state(params, 2, opt, strat, axes)
    step = jax.jit(make_round_step(lambda p, b: T.lm_loss(cfg, p, b), opt, strat, schedules.constant(LR), axes))
    for b in batches:
        state, ms = step(state, {k: jnp.asarray(v) for k, v in b.items()})
        out["loss"].append(np.asarray(ms["loss"], np.float32))
        out["x"].append(planes(state.x))
assert len(state.x.buffers[0].sharding.device_set) == 4
out["params"] = jax.tree.map(lambda a: np.asarray(a, np.float32), params)
out.update(z=planes(state.vars.z), v=planes(state.vars.v), inflight=planes(state.inflight),
           momentum=planes(state.opt.momentum))
with open(sys.argv[1], "wb") as f:
    pickle.dump(out, f)
print("REFERENCE OK")
""" % (LR, ROUNDS)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("fsdp_jax") / "ref.pkl"
    env = dict(os.environ, PYTHONPATH=SRC)
    env.pop("XLA_FLAGS", None)
    env["JAX_PLATFORMS"] = "cpu"
    try:
        proc = subprocess.run([sys.executable, "-c", REFERENCE, str(path)], env=env, capture_output=True, text=True,
                              timeout=_TIMEOUT)
    except subprocess.TimeoutExpired:
        pytest.fail(f"the reference's mesh round exceeded {_TIMEOUT}s (REPRO_SUBPROC_TIMEOUT to raise)")
    assert proc.returncode == 0 and "REFERENCE OK" in proc.stdout, proc.stderr[-4000:]
    with open(path, "rb") as f:
        return pickle.load(f)


def test_a_2x2_round_of_qwen2_matches_the_reference_s_mesh_round(reference, tmp_path):
    torch.set_num_threads(1)
    case = dict(model="qwen2-7b", strategy=dict(anchor_beta=0.7, tau=2), dtype="float32", m=2, lr=LR,
                params=reference["params"], batches=reference["batches"])
    per_rank = ranks.spawn(tmp_path, [case], 4, fsdp=2)
    got = [res[0] for res in per_rank]
    for res in got[1:]:  # the worker's F ranks hold (and gather) the same rows; the anchor alike everywhere
        for key in ("z", "v", "inflight"):
            assert all(ranks.same_bytes(a, b) for a, b in zip(res[key], got[0][key])), key
    for r in range(ROUNDS):
        np.testing.assert_allclose(np.concatenate([got[w * 2]["loss"][r] for w in range(2)], axis=-1),
                                   reference["loss"][r], rtol=1e-5)
    rows = lambda key: [np.concatenate([got[w * 2][key][b] for w in range(2)]) for b in range(len(got[0][key]))]
    planes = {"x0": (rows("x0"), reference["x"][0]), "x": (rows("x"), reference["x"][-1]),
              "z": (got[0]["z"], reference["z"]), "v": (got[0]["v"], reference["v"]),
              "inflight": (got[0]["inflight"], reference["inflight"])}
    for key, (g, w) in planes.items():
        for gb, wb in zip(g, w):
            np.testing.assert_allclose(gb, wb, rtol=1e-5, atol=1e-6, err_msg=key)
    for gb, wb in zip(rows("momentum"), reference["momentum"]):
        assert np.abs(gb - wb).max() <= 1e-5 * np.abs(wb).max()
