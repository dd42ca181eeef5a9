"""The worker axis over ``torch.distributed`` ranks (``repro_torch.parallel.
sharding``, ``launch/mesh.py``, the strategies' rank boundaries, K3/K4's rank
form on its plain path), on the CPU over gloo.

The ranks are spawned by ``tests/torch_dist_ranks.py`` (one subprocess a
group, ``torch.multiprocessing`` inside, a ``file://`` rendezvous in the
test's own ``tmp_path``, so parallel test workers never share a port; the
budget of each spawn is ``REPRO_SUBPROC_TIMEOUT``, 300 s by default). They
import no JAX: the JAX package's rounds are computed here, in the test
process, from the same weights and batches. Stated bounds and why:

* two ranks of one row each (m 2) against the port's one-process run at m 2:
  **bit for bit**, every plane (x after each round, the momentum, z, v and
  the drained in-flight anchor) and the losses, for Overlap-Local-SGD
  (β 0.7: K3's rank form, β 0: K4's), Local SGD and sync-SGD, f32 and bf16,
  on the classifier and the reduced h2o-danube-1.8b: the local steps are
  the same per row, and the worker sum of two f32 terms commutes;
* the same ranks against the JAX package's stacked rounds: the bounds of
  the stacked port against JAX (``tests/test_torch_training.py``,
  ``tests/test_torch_archs.py``): f32 x, z, v, in-flight rtol 1e-5 atol
  1e-6 (the momentum per leaf 1e-5·max on the LM), bf16 planes within 2
  bf16 ulps of max|x| (the classifier) or 1 (the LM's planes; the momentum
  4 ulps of its own largest), losses rtol 1e-5 (bf16: 1e-3, the bf16 LM
  round's bound of ``tests/test_torch_lm.py``);
* four ranks of one row, and two ranks of two rows (m 4), against the
  one-process run at m 4: the transport adds the partial sums in its own
  order, not 0 .. m−1, so each worker mean may differ in its last bits.
  After the first round x and the consumed anchor are bitwise (the first
  boundary pulls toward the initial anchor, which no sum made). After the
  second, drained: z (one sum in another order) within (m − 1) f32 ulps of
  each slot's largest |z| (bf16: 1 ulp); x, v and the in-flight anchor
  (two sums) within 2 (m − 1) (bf16: 2). Observed: see CHANGES.md;
* z, v and the in-flight anchor equal bit for bit on every rank.
"""
import dataclasses
import datetime
import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_ranks as ranks
from repro.api import ClassificationSpec as JSpec
from repro.api import Experiment as JExperiment
from repro.api import TokenStream as JTokenStream
from repro.config import AlgoConfig as JAlgo
from repro.config import OptimizerConfig as JOpt
from repro.config import get_arch as jax_get_arch
from repro.optim import schedules as jsched
from repro.training import make_train_state as jmake_train_state
from repro_torch.config import AlgoConfig, ParallelPlan, get_arch
from repro_torch.core import make_strategy
from repro_torch.data import loaders

SRC = Path(__file__).resolve().parents[1] / "src"
HELPER = Path(__file__).with_name("torch_dist_ranks.py")
_TIMEOUT = int(os.environ.get("REPRO_SUBPROC_TIMEOUT", "300"))
DANUBE = "h2o-danube-1.8b"
LR, ROUNDS = 1e-2, 2
STRATS = {"overlap": {}, "overlap_beta0": {"anchor_beta": 0.0}, "local_sgd": {"name": "local_sgd"},
          "sync_sgd": {"name": "sync_sgd"}}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The ranks run one thread each; the one-process run here does too."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _f32(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _case(model, strat, dtype, m, record=False):
    """(a case for ``torch_dist_ranks.run_case``, the JAX experiment on the
    same weights and batches)."""
    strategy = STRATS[strat]
    tau = make_strategy(AlgoConfig(**strategy)).tau
    if model == "classifier":
        j = JExperiment(task=JSpec(n=2000, holdout=500), strategy=JAlgo(**strategy), workers=m).build()
        if dtype == "bfloat16":
            jparams = jax.tree.map(lambda a: a.astype(jnp.bfloat16), j.params)
            j.state = jmake_train_state(jparams, m, j.opt_obj, j.strategy_obj, j.axes)
        nb = loaders.classification_batch_fn(loaders.make_classification_splits(m, n=2000, holdout=500), 32, seed=0)
        lr = None
    else:
        jcfg = dataclasses.replace(jax_get_arch(model).model.reduced(), dtype=dtype)
        j = JExperiment(arch=jcfg, strategy=JAlgo(**strategy), optimizer=JOpt(name="sgd", lr=LR),
                        schedule=jsched.constant(LR), data=JTokenStream(2, 32), workers=m).build()
        nb = loaders.lm_batch_fn(get_arch(model).model.reduced(), m, 2, 32, seed=3)
        lr = LR
    batches = [loaders.round_batch(nb, tau) for _ in range(ROUNDS)]
    case = dict(model=model, strategy=strategy, dtype=dtype, m=m, params=_f32(j.params), batches=batches, lr=lr,
                record=record)
    return case, j


def _spawn(cases, world, where) -> list:
    """Run ``cases`` on ``world`` gloo ranks; per rank, the results of each."""
    where.mkdir()
    with open(where / "cases.pkl", "wb") as f:
        pickle.dump(cases, f)
    env = dict(os.environ, PYTHONPATH=str(SRC), REPRO_SUBPROC_TIMEOUT=str(_TIMEOUT))
    try:
        proc = subprocess.run([sys.executable, str(HELPER), str(where / "cases.pkl"), str(where), str(world)],
                              env=env, capture_output=True, text=True, timeout=_TIMEOUT)
    except subprocess.TimeoutExpired:
        pytest.fail(f"{world} ranks exceeded {_TIMEOUT}s (REPRO_SUBPROC_TIMEOUT to raise)")
    assert proc.returncode == 0, proc.stderr[-6000:]
    out = []
    for r in range(world):
        with open(where / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


def _gather(per_rank, key):
    """A plane's buckets with the ranks' rows stacked in rank order."""
    return [np.concatenate([res[key][b] for res in per_rank]) for b in range(len(per_rank[0][key]))]


def _equal_planes(a, b):
    return len(a) == len(b) and all(np.array_equal(x, y) for x, y in zip(a, b))


def _jax_rounds(j, case):
    state, ms = j.state, None
    losses = []
    for rb in case["batches"]:
        state, ms = j.step_fn(state, rb)
        losses.append(np.asarray(ms["loss"], np.float32))
    return state, losses


def _jplane(p):
    return [np.asarray(b.astype(jnp.float32)) for b in p.buffers]


def _ulp(a, bits, n=1):
    return n * np.ldexp(np.float32(1), np.frexp(np.abs(a).max())[1] - bits)


# -- two ranks, one row each --------------------------------------------------------

W2 = [(model, strat, dtype) for model in ("classifier", DANUBE) for strat in STRATS
      for dtype in ("float32", "bfloat16")]


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    built = [_case(model, strat, dtype, 2, record=strat.startswith("overlap")) for model, strat, dtype in W2]
    cases = [c for c, _ in built]
    return built, _spawn(cases, 2, tmp_path_factory.mktemp("dist") / "w2")


@pytest.mark.parametrize("idx", range(len(W2)), ids=["-".join(c) for c in W2])
def test_two_ranks_of_one_row_are_the_stacked_run_bit_for_bit(two_ranks, idx):
    (case, j), per_rank = two_ranks[0][idx], [res[idx] for res in two_ranks[1]]
    model, strat, dtype = W2[idx]
    one = ranks.run_case(case)  # the port, one process, m 2
    for key in ("x0", "x", "momentum"):
        assert _equal_planes(_gather(per_rank, key), one[key]), key
    for key in ("z0", "z", "v", "inflight"):
        if key in one:
            assert all(_equal_planes(res[key], one[key]) for res in per_rank), key
    assert np.array_equal(np.concatenate([np.stack(res["loss"]) for res in per_rank], axis=-1), np.stack(one["loss"]))
    # against the JAX package's stacked rounds
    jstate, jlosses = _jax_rounds(j, case)
    want = {"x": _jplane(jstate.x), "momentum": _jplane(jstate.opt.momentum)}
    if jstate.vars.z is not None:
        want.update(z=_jplane(jstate.vars.z), v=_jplane(jstate.vars.v))
    if jstate.inflight is not None:
        want["inflight"] = _jplane(jstate.inflight)
    lm = model != "classifier"
    for key, w in want.items():
        got = per_rank[0][key] if key in ("z", "v", "inflight") else _gather(per_rank, key)
        for g, wb, xb in zip(got, w, want["x"]):
            if dtype == "float32" and key == "momentum" and lm:
                assert np.abs(g - wb).max() <= 1e-5 * np.abs(wb).max(), key
            elif dtype == "float32":
                np.testing.assert_allclose(g, wb, rtol=1e-5, atol=1e-6, err_msg=key)
            else:
                lim = _ulp(wb, 8, 4 if lm else 2) if key == "momentum" else _ulp(xb, 8, 1 if lm else 2)
                assert np.abs(g - wb).max() <= lim, (key, np.abs(g - wb).max(), lim)
    rtol = 1e-3 if dtype == "bfloat16" else 1e-5
    np.testing.assert_allclose(np.stack(one["loss"]), np.stack(jlosses), rtol=rtol)


@pytest.mark.parametrize("strat", ["overlap", "overlap_beta0"])
def test_the_handle_of_boundary_k_is_waited_at_boundary_k_plus_1(two_ranks, strat):
    """The recorded trace on each rank: every boundary launches one
    collective (the anchor's reduce-scatter); the one launched at boundary k
    is first waited at boundary
    k + 1, after that round's τ optimizer steps, and the last by drain."""
    idx = W2.index(("classifier", strat, "float32"))
    tau = 2
    want = []
    for k in range(ROUNDS):
        want += [("step",)] * tau + ([("wait", k - 1)] if k else []) + [("launch", k)]
    want += [("wait", ROUNDS - 1)]
    for res in two_ranks[1]:
        assert res[idx]["events"] == want


# -- more ranks, or more rows a rank: within the stated bounds -------------------------

WIDE = [("overlap", "float32"), ("overlap", "bfloat16"), ("overlap_beta0", "float32"), ("local_sgd", "float32")]


@pytest.fixture(scope="module")
def four_workers(tmp_path_factory):
    built = [_case("classifier", strat, dtype, 4) for strat, dtype in WIDE]
    cases = [c for c, _ in built]
    base = tmp_path_factory.mktemp("dist")
    return cases, {w: _spawn(cases, w, base / f"w{w}") for w in (4, 2)}


@pytest.mark.parametrize("world", [4, 2], ids=["4x1", "2x2"])
@pytest.mark.parametrize("idx", range(len(WIDE)), ids=["-".join(c) for c in WIDE])
def test_four_workers_on_more_ranks_within_bounds(four_workers, world, idx):
    from repro_torch.parallel.packing import layout_of

    cases, results = four_workers
    case, per_rank = cases[idx], [res[idx] for res in results[world]]
    one = ranks.run_case(case)
    layout = layout_of(ranks._params(case))
    m, bits = case["m"], (24 if case["dtype"] == "float32" else 8)
    per_sum = (m - 1) if bits == 24 else 1
    local = case["strategy"].get("name") == "local_sgd"
    # sums in another order behind each plane: Local SGD's x is a mean after
    # each round; Overlap's first boundary pulls toward the initial anchor,
    # which no sum made, so its first x and z are bitwise
    sums = {"x0": 1 if local else 0, "z0": 0, "x": 2, "z": 1, "v": 2, "inflight": 2}
    worst = {}
    for key, n_sums in sums.items():
        if key not in one:
            continue
        got = _gather(per_rank, key) if key.startswith("x") else per_rank[0][key]
        if not key.startswith("x"):  # replicated: bit for bit on every rank
            assert all(_equal_planes(res[key], per_rank[0][key]) for res in per_rank[1:]), key
        for s in layout.slots:
            cut = slice(s.offset, s.offset + s.size)
            g, w, x = got[s.bucket][..., cut], one[key][s.bucket][..., cut], one["x"][s.bucket][..., cut]
            err = float(np.abs(g - w).max())
            lim = float(_ulp(x, bits, n_sums * per_sum))
            assert err <= lim, (key, world, layout.paths[s.index], err, lim)
            worst[key] = max(worst.get(key, 0.0), err / float(_ulp(x, bits)))
    print(f"observed, in ulps of each slot's largest |x|: {worst}")


# -- one rank in this process, the refusals ---------------------------------------------


@pytest.fixture
def one_rank(tmp_path):
    """A one-rank gloo group in this process, destroyed afterwards."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_smoke_mesh

    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rendezvous'}", world_size=1, rank=0,
                            timeout=datetime.timedelta(seconds=60))
    try:
        yield make_smoke_mesh(1, device="cpu")
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("strat", list(STRATS))
def test_one_rank_is_the_stacked_run_bit_for_bit(one_rank, strat):
    """W 1 (the one-card NCCL path's shape): m 2 rows on one rank."""
    from repro_torch.parallel.sharding import mesh_context

    case, _ = _case("classifier", strat, "float32", 2)
    with mesh_context(one_rank):
        got = ranks.run_case(case)
    one = ranks.run_case(case)
    assert sorted(got) == sorted(one)
    for key in got:
        if key != "loss":
            assert _equal_planes(got[key], one[key]), key
    assert np.array_equal(np.stack(got["loss"]), np.stack(one["loss"]))


def test_unported_paths_on_ranks_raise_naming_their_item(one_rank, tmp_path):
    """Tensor parallelism, not ported to a worker mesh, raises
    NotImplementedError naming ROADMAP item 10c (its second part), a mesh of
    W x F ranks needs W·F processes (fsdp runs since item 10c's first part:
    ``tests/test_torch_dist_fsdp.py``), and a strategy of one's own with no
    rank boundary raises; what item 10b ported runs
    (every strategy: easgd, cocod, delayed_avg, sparse_anchor, powersgd and
    the gossip family; the per-leaf path, a legacy Algorithm and offload,
    each a round that ends with finite planes; the probe, a membership,
    Experiment.fit and the readers of all m workers; the checkpointer's save
    and restore)."""
    import torch.distributed as dist

    from repro_torch import checkpoint
    from repro_torch.api import ClassificationSpec, Experiment
    from repro_torch.core.algorithms import make_algorithm
    from repro_torch.fault import from_mask
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.models import classifier as clf
    from repro_torch.optim import from_config, schedules
    from repro_torch.config import OptimizerConfig
    from repro_torch.core.strategy import CommStrategy
    from repro_torch.parallel.sharding import logical_mesh, mesh_context
    from repro_torch.training import drain, make_round_step, make_train_state

    with pytest.raises(ValueError, match="processes"):
        make_smoke_mesh(1, fsdp=2)
    with pytest.raises(NotImplementedError, match="item 10c, second part"):
        logical_mesh(ParallelPlan(1, 1, 2), device="cpu")
    with pytest.raises(ValueError, match="processes"):
        make_smoke_mesh(2, device="cpu")
    assert dist.get_world_size() == 1
    params = clf.init_mlp(torch.Generator().manual_seed(0), 8, 3, hidden=(4,))
    opt = from_config(OptimizerConfig())
    with mesh_context(one_rank):
        # ported: the rank's rows, and a round through each rank boundary
        for name in ("easgd", "cocod", "delayed_avg", "sparse_anchor", "powersgd", "gossip_ring", "gossip_exp",
                     "gossip_full", "gossip_pushsum"):
            strat = make_strategy(AlgoConfig(name=name))
            state = make_train_state(params, 2, opt, strat)
            assert state.x.lead_shape == (2,)
            step = make_round_step(clf.mlp_loss, opt, strat, schedules.constant(0.1))
            batch = (torch.zeros(strat.tau, 2, 2, 8), torch.zeros(strat.tau, 2, 2, dtype=torch.int32))
            assert all(torch.isfinite(b).all() for b in step(state, batch)[0].x.buffers), name
        # ported (item 10b's third part): the per-leaf path, offload and a legacy Algorithm
        with pytest.warns(DeprecationWarning):
            legacy = make_algorithm(AlgoConfig())
        for strategy in (make_strategy(AlgoConfig(packed=False)),
                         make_strategy(AlgoConfig(offload=True, offload_chunk_mb=1 / 64)), legacy):
            state = make_train_state(params, 2, opt, strategy)
            step = make_round_step(clf.mlp_loss, opt, strategy, schedules.constant(0.1))
            batch = (torch.zeros(strategy.tau, 2, 2, 8), torch.zeros(strategy.tau, 2, 2, dtype=torch.int32))
            x = drain(step(state, batch)[0]).x
            assert all(torch.isfinite(t).all() for t in (x.values() if isinstance(x, dict) else x.buffers))

        class OwnStrategy(CommStrategy):  # a strategy of one's own: no rank boundary
            name = "own"

        with pytest.raises(NotImplementedError, match="no rank boundary"):
            make_train_state(params, 2, opt, OwnStrategy(AlgoConfig()))
        with pytest.raises(ValueError, match="divide"):
            one_rank.rows(0)
        strat = make_strategy(AlgoConfig())
        state = make_train_state(params, 2, opt, strat)
        x = torch.zeros(2, 2, 2, 8)
        batch = (x, torch.zeros(2, 2, 2, dtype=torch.int32))
        probed = make_round_step(clf.mlp_loss, opt, strat, schedules.constant(0.1), probe=True)
        _, ms = probed(state, batch)  # ported: the probe's stats over all ranks
        assert torch.isfinite(ms["consensus_drift"]) and torch.isfinite(ms["consensus_scale"])
        plain = make_round_step(clf.mlp_loss, opt, strat, schedules.constant(0.1))
        # ported: a membership masks the rank boundary
        state = plain(state._replace(membership=from_mask(np.array([1.0, 0.0], np.float32))), batch)[0]
        state = state._replace(membership=None)
        with pytest.raises(ValueError, match="all 2 workers"):
            plain(state, (x[:, :1], batch[1][:, :1]))
        # ported: the checkpointer saves the drained state and restores it
        checkpoint.save(str(tmp_path / "c.npz"), state)
        back = checkpoint.restore(str(tmp_path / "c.npz"), state)
        assert all(torch.equal(a, b) for a, b in zip(back.x.buffers, state.x.buffers))
        exp = Experiment(task=ClassificationSpec(n=600, holdout=100), workers=2, device="cpu").build()
        assert exp.state.x.buffers[0].shape[0] == 2  # W 1: all rows on this rank
        # ported: fit and the readers of all m workers run on the mesh
        assert len(exp.fit(rounds=2).losses) == 2
        assert exp.consensus_plane().lead_shape == () and set(exp.consensus()) == set(exp.params)
        assert 0.0 <= exp.evaluate()["test_acc"] <= 1.0
        with pytest.raises(ValueError, match="LM experiment"):  # the task's own refusal, not the mesh's
            exp.serve()


def test_sharding_refuses_without_a_group_or_a_mesh():
    from repro_torch.parallel import sharding

    if not torch.distributed.is_initialized():
        with pytest.raises(RuntimeError, match="init_process_group"):
            sharding.logical_mesh(ParallelPlan(2, 1, 1), device="cpu")
    with pytest.raises(RuntimeError, match="mesh_context"):
        sharding.all_reduce_async(torch.zeros(4))
    assert sharding.current_mesh() is None
