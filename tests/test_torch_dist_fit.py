"""The paper's experiment on worker ranks: ``Experiment.fit`` over
``torch.distributed`` (gloo CPU ranks) with faults, adaptive τ and both, for
Overlap-Local-SGD (β 0.7 and 0), Local SGD, sync-SGD, EASGD, CoCoD-SGD and
delayed averaging, and the readers of all m workers; the plain versions of
K3/K4's rank-form operands (weights, ``mean_pre``, the weighted finish) and
of K8's rank form.

The ranks run ``tests/torch_dist_ranks.py::run_fit_case`` in one spawn of
two ranks (every case, m 2 and m 4), importing no JAX; the one-process port
and the JAX package's ``Experiment.fit`` run here, on the same weights (the
reference's built state, carried across as numpy), batches, plan and
controller. The small classification task (2,000 samples, 500 held out),
τ 2 (delayed averaging: delay 1, consumed mid-round), 3 rounds; the plan
``crash:1@1-2`` at m 2 and ``crash:1@1-2,slow:2x4`` at m 4 (seed 7), the
controller τ 1 in [1, 4], band [0.05, 0.5]. Stated bounds and why:

* two ranks of one row each (m 2) against the one-process port at m 2,
  f32 and bf16: **bit for bit** — losses, x, the momentum, vars, the drained
  in-flight value, the fault log, the τ schedule's rounds, τs and
  decisions, and the readers (``consensus()``, ``consensus_plane()``,
  ``anchor_plane()``, ``evaluate()``), which are also equal on both ranks.
  Every worker sum is of two f32 terms, which commutes. The probe's drift
  and scale within rtol 1e-6: the ranks add their drift squares in float64,
  the one-process plain probe in float32 in PyTorch's order;
* the same ranks against the JAX package's fits: the bounds of
  ``tests/test_torch_fault.py`` and ``tests/test_torch_control.py`` — the
  fault log and the τ schedule's decisions exactly, losses rtol 1e-4 (bf16:
  1e-3, the bf16 round's bound of ``tests/test_torch_dist.py``), drift and
  scale rtol 1e-5 (bf16: 1e-3);
* four workers on two ranks of two rows against the one-process port at m
  4: the transport adds the two ranks' partial sums, so a worker sum of four
  terms is added in another order than 0 .. 3 and may differ in its last
  bits; the schedule's decisions and the fault log exactly, every plane
  within 2(m − 1) f32 ulps of its largest magnitude (``M4_ULPS``: a
  boundary's one or two reordered sums, (m − 1) ulps each, as
  ``tests/test_torch_dist.py`` states; observed at most 3 over the 3
  rounds) and the losses within rtol 1e-5, the readers equal on both
  ranks;
* a probed round's collectives: one extra n-wide f32 all-reduce (the
  unweighted row sums that give x̄) and one float64 scalar all-reduce a
  round, except Local SGD with no membership, whose own blocking sum gives
  x̄ (the scalar only);
* the plain rank forms against the reference ``ref.py`` on slices of rows:
  the slices' partial sums added (two terms: bit for bit the worker sum in
  the reference's order on two rows) within 2 f32 ulps of the reference's
  mean (XLA's sum order), the rows and z' bit for bit; K8's rank form
  summed over the slices within rtol 1e-6 of ``plane_probe``.
"""
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
from repro.config import AlgoConfig as JAlgo
from repro.control import TauController as JTauController
from repro.data.loaders import classification_batch_fn as jbatch_fn
from repro.fault import FaultPlan as JFaultPlan
from repro.kernels.anchor_mix import ref as janchor_ref
from repro.kernels.consensus_probe import ref as jprobe_ref
from repro.training import make_train_state as jmake_train_state
from repro_torch.config import AlgoConfig
from repro_torch.core import make_strategy

SRC = Path(__file__).resolve().parents[1] / "src"
HELPER = Path(__file__).with_name("torch_dist_ranks.py")
_TIMEOUT = int(os.environ.get("REPRO_SUBPROC_TIMEOUT", "300"))
SMALL = dict(n=2000, holdout=500)
ROUNDS = 3
CASES = {"overlap": {}, "overlap_beta0": {"anchor_beta": 0.0}, "local_sgd": {"name": "local_sgd"},
         "sync_sgd": {"name": "sync_sgd"}, "easgd": {"name": "easgd"}, "cocod": {"name": "cocod"},
         "delayed_avg": {"name": "delayed_avg", "delay_steps": 1}}
CTRL = dict(tau=1, tau_min=1, tau_max=4, lo=0.05, hi=0.5)
PLANS = {2: ("crash:1@1-2", 7), 4: ("crash:1@1-2,slow:2x4", 7)}
MODES = {"faults": (True, False), "adaptive": (False, True), "both": (True, True)}
SCHEDULE_KEYS = ("round", "tau", "decision", "next_tau", "fault")
M4_ULPS = 2 * (4 - 1)

W2 = [(strat, dtype, mode) for strat in CASES for dtype in ("float32", "bfloat16") for mode in MODES]
M4 = [(strat, "float32", mode) for strat in CASES for mode in ("faults", "both")]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The ranks run one thread each; the one-process run here does too."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _strategy(strat):
    return dict(CASES[strat], tau=2)


_JAX = {}


def _jax_experiment(strat, dtype, m):
    """The reference's experiment of a case and its initial state (built
    once a strategy, dtype and m; each fit starts again from it)."""
    key = (strat, dtype, m)
    if key not in _JAX:
        j = JExperiment(task=JSpec(**SMALL), strategy=JAlgo(**_strategy(strat)), workers=m).build()
        if dtype == "bfloat16":
            jparams = jax.tree.map(lambda a: a.astype(jnp.bfloat16), j.params)
            j.state = jmake_train_state(jparams, m, j.opt_obj, j.strategy_obj, j.axes)
        _JAX[key] = (j, j.state)
    return _JAX[key]


def _case(strat, dtype, mode, m, params):
    faults, adaptive = MODES[mode]
    return dict(fit=True, strategy=_strategy(strat), dtype=dtype, m=m, rounds=ROUNDS, params=params,
                plan=PLANS[m] if faults else None, ctrl=CTRL if adaptive else None)


def _jax_fit(case, strat):
    """The reference's ``Experiment.fit`` of ``case``, from its initial state
    and a fresh batch stream."""
    j, state0 = _jax_experiment(strat, case["dtype"], case["m"])
    j.state = state0
    j.next_batch = jbatch_fn(j.splits, j.task.batch_per_worker, seed=j.task.seed)
    kw = {}
    if case["plan"]:
        kw["faults"] = JFaultPlan.parse(case["plan"][0], m=case["m"], seed=case["plan"][1])
    if case["ctrl"]:
        kw["adaptive_tau"] = JTauController(**case["ctrl"])
    return j.fit(rounds=case["rounds"], **kw)


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """Every case on two gloo ranks, in one spawn: the m 2 cases (one row a
    rank), then the m 4 cases (two rows a rank)."""
    # the reference's initial weights (the same for every strategy and m)
    j = JExperiment(task=JSpec(**SMALL), workers=2).build()
    params = jax.tree.map(lambda a: np.asarray(a, np.float32), j.params)
    cases = [_case(*c, 2, params) for c in W2] + [_case(*c, 4, params) for c in M4]
    where = tmp_path_factory.mktemp("dist_fit") / "w2"
    where.mkdir()
    with open(where / "cases.pkl", "wb") as f:
        pickle.dump(cases, f)
    env = dict(os.environ, PYTHONPATH=str(SRC), REPRO_SUBPROC_TIMEOUT=str(_TIMEOUT))
    try:
        proc = subprocess.run([sys.executable, str(HELPER), str(where / "cases.pkl"), str(where), "2"],
                              env=env, capture_output=True, text=True, timeout=_TIMEOUT)
    except subprocess.TimeoutExpired:
        pytest.fail(f"2 ranks exceeded {_TIMEOUT}s (REPRO_SUBPROC_TIMEOUT to raise)")
    assert proc.returncode == 0, proc.stderr[-6000:]
    per_rank = []
    for r in range(2):
        with open(where / f"rank{r}.pkl", "rb") as f:
            per_rank.append(pickle.load(f))
    return cases, per_rank


def _results(spawned, idx):
    cases, per_rank = spawned
    return cases[idx], [res[idx] for res in per_rank]


def _gather(per_rank, key):
    """A plane's buckets with the ranks' rows stacked in rank order."""
    return [np.concatenate([res[key][b] for res in per_rank]) for b in range(len(per_rank[0][key]))]


def _equal(a, b):
    return len(a) == len(b) and all(np.array_equal(x, y) for x, y in zip(a, b))


def _schedule(sched):
    return None if sched is None else [{k: h.get(k) for k in SCHEDULE_KEYS} for h in sched]


ROWS = ("x", "momentum", "inflight_x0")
REPLICATED = ("vars", "inflight", "consensus", "consensus_plane", "anchor_plane")


def _readers_equal_on_ranks(per_rank):
    for key in REPLICATED:
        if key in per_rank[0]:
            assert all(_equal(res[key], per_rank[0][key]) for res in per_rank[1:]), key
    assert all(res["evaluate"] == per_rank[0]["evaluate"] for res in per_rank)
    for res in per_rank[1:]:  # the controller's records, stats included, alike on every rank
        assert res["tau_schedule"] == per_rank[0]["tau_schedule"] and res["fault_log"] == per_rank[0]["fault_log"]
        assert res["loss"] == per_rank[0]["loss"]


# -- two ranks of one row: the one-process port bit for bit, JAX within bounds ----------


@pytest.mark.parametrize("idx", range(len(W2)), ids=["-".join(c) for c in W2])
def test_two_ranks_fit_is_the_one_process_fit_bit_for_bit(spawned, idx):
    case, per_rank = _results(spawned, idx)
    one = ranks.run_fit_case(case)
    _readers_equal_on_ranks(per_rank)
    got = per_rank[0]
    assert got["loss"] == one["loss"]
    assert got["fault_log"] == one["fault_log"] and got["steps"] == one["steps"]
    assert _schedule(got["tau_schedule"]) == _schedule(one["tau_schedule"])
    if one["tau_schedule"] is not None:
        for name in ("drift", "scale"):
            np.testing.assert_allclose([h[name] for h in got["tau_schedule"]],
                                       [h[name] for h in one["tau_schedule"]], rtol=1e-6)
    for key in ROWS:
        if key in one:
            assert _equal(_gather(per_rank, key), one[key]), key
    for key in REPLICATED:
        if key in one:
            assert _equal(got[key], one[key]), key
    assert got["evaluate"] == one["evaluate"]
    assert sorted(got) == sorted(one)


@pytest.mark.parametrize("idx", range(len(W2)), ids=["-".join(c) for c in W2])
def test_two_ranks_fit_matches_jax(spawned, idx):
    case, per_rank = _results(spawned, idx)
    jres = _jax_fit(case, W2[idx][0])
    got = per_rank[0]
    bf16 = case["dtype"] == "bfloat16"
    assert got["fault_log"] == jres.fault_log
    assert got["steps"] == jres.steps
    assert _schedule(got["tau_schedule"]) == _schedule(jres.tau_schedule)
    if jres.tau_schedule is not None:
        for name in ("drift", "scale"):
            np.testing.assert_allclose([h[name] for h in got["tau_schedule"]],
                                       [h[name] for h in jres.tau_schedule], rtol=1e-3 if bf16 else 1e-5)
    np.testing.assert_allclose(got["loss"], jres.losses, rtol=1e-3 if bf16 else 1e-4)
    assert np.isfinite(got["loss"]).all()


# -- four workers on two ranks of two rows -------------------------------------------------


@pytest.mark.parametrize("idx", range(len(M4)), ids=["-".join(c) for c in M4])
def test_four_workers_on_two_ranks_within_bounds(spawned, idx):
    case, per_rank = _results(spawned, len(W2) + idx)
    one = ranks.run_fit_case(case)
    _readers_equal_on_ranks(per_rank)
    got = per_rank[0]
    assert got["fault_log"] == one["fault_log"] and got["steps"] == one["steps"]
    assert _schedule(got["tau_schedule"]) == _schedule(one["tau_schedule"])
    by_round = {rec["round"]: rec for rec in got["fault_log"]}
    assert by_round[1]["excluded"] == [1, 2] and by_round[2]["resynced"] == [1]
    np.testing.assert_allclose(got["loss"], one["loss"], rtol=1e-5)
    worst = 0.0
    for key in ROWS + REPLICATED:
        if key not in one:
            continue
        planes = _gather(per_rank, key) if key in ROWS else got[key]
        for g, w in zip(planes, one[key]):
            ulp = np.spacing(np.float32(np.abs(w).max()))
            err = float(np.abs(g.astype(np.float64) - w).max())
            worst = max(worst, err / ulp)
            assert err <= M4_ULPS * ulp, (key, err / ulp)
    print(f"observed: {worst:.0f} f32 ulps of the largest magnitude")


# -- a probed round's collectives ----------------------------------------------------------


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


@pytest.mark.parametrize("strat", list(CASES))
@pytest.mark.parametrize("masked", [False, True], ids=["live", "masked"])
def test_a_probed_round_adds_one_plane_wide_collective(one_rank, strat, masked):
    """The all-reduces of one boundary on a rank, unprobed and probed: the
    probe adds one n-wide f32 sum and one float64 sum of the buckets' drift,
    except Local SGD fully live (its own sum gives x̄)."""
    from repro_torch.fault import from_mask
    from repro_torch.parallel import sharding
    from repro_torch.parallel.packing import pack
    from repro_torch.parallel.sharding import mesh_context

    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(2, 256)).astype(np.float32))
    strategy = make_strategy(AlgoConfig(**_strategy(strat)))
    mem = from_mask(np.array([1.0, 0.0], np.float32)) if masked else None
    calls = []
    real = sharding.all_reduce_async

    def reduce(buf, mesh=None):
        calls.append((str(buf.dtype), buf.numel()))
        return real(buf, mesh)

    counts = {}
    with mesh_context(one_rank):
        for probe in (False, True):
            px = pack({"w": x.clone()}, lead=1)
            vars = strategy.init_vars(px)
            inflight = strategy.init_inflight(px, vars)
            sharding.all_reduce_async = reduce
            try:
                calls.clear()
                out = strategy.boundary_round(px, vars, inflight, probe=probe, membership=mem)
                for _ in range(2):  # the next boundary waits on what this one launched
                    out = strategy.boundary_round(out[0], out[1], out[2], probe=probe, membership=mem)
            finally:
                sharding.all_reduce_async = real
            counts[probe] = list(calls)
    n = px.buffers[0].shape[-1]
    extra = list(counts[True])
    for c in counts[False]:
        extra.remove(c)
    wide = 0 if (strat == "local_sgd" and not masked) else 1
    assert sorted(extra) == sorted([("torch.float32", n)] * (3 * wide) + [("torch.float64", 1)] * 3), extra


# -- the plain rank forms against the reference on slices of rows ---------------------------


def _slices(m):
    return [slice(0, m // 2), slice(m // 2, m)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("weighted", [False, True], ids=["live", "weighted"])
@pytest.mark.parametrize("mean_pre", [False, True], ids=["post", "pre"])
def test_rank_form_operands_match_the_reference(dtype, weighted, mean_pre):
    """K3/K4's rank form on two slices of rows (a dead row in the weighted
    case) against the reference's K4 ``pullback_mean`` over all rows: the
    rows bit for bit, the two partial sums added and finished (S / m, or S
    for a weighted sum) within 2 f32 ulps of the reference's mean; then the
    finish of K3 against ``pullback_mean_momentum`` the same way."""
    from repro_torch.kernels.anchor_mix import ref

    m, n, alpha, beta = 4, 300, 0.6, 0.7
    rng = np.random.default_rng(3)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    x = rng.normal(size=(m, n)).astype(np.float32)
    z = rng.normal(size=n).astype(np.float32)
    v = (0.1 * rng.normal(size=n)).astype(np.float32)
    w = np.array([0.5, 0.0, 0.25, 0.25], np.float32) if weighted else None
    jx, jz, jv = (jnp.asarray(a).astype(jdt) for a in (x, z, v))
    jw = None if w is None else jnp.asarray(w)
    jx_new, jmean = janchor_ref.pullback_mean(jx, jz, alpha, mean_pre=mean_pre, weights=jw)
    tx, tz, tv = (torch.from_numpy(a).to(tdt) for a in (x, z, v))
    tw = None if w is None else torch.from_numpy(w)
    s = torch.zeros(n)
    rows = []
    for c in _slices(m):
        x_new, z_out, _, part = ref.pullback_rank(tx[c], tz, None, None, m, alpha, None, 0,
                                                  None if tw is None else tw[c], mean_pre)
        assert z_out is tz
        rows.append(x_new)
        s = s + part
    np.testing.assert_array_equal(torch.cat(rows).float().numpy(), np.asarray(jx_new.astype(jnp.float32)))
    fin = 2 if weighted else 1
    _, mean, _, _ = ref.pullback_rank(tx[:0], tz, None, s, m, alpha, None, fin)
    want = np.asarray(jmean.astype(jnp.float32))
    lim = 2 * np.spacing(np.float32(np.abs(want).max())) if dtype == "float32" else 0.0
    assert np.abs(mean.float().numpy() - want).max() <= lim
    if not mean_pre:  # K3's finish from the same sum
        _, jz_next, jv_new = janchor_ref.pullback_mean_momentum(jx, jz, jv, alpha, beta, weights=jw)
        _, z_next, v_new, _ = ref.pullback_rank(tx[:0], tz, tv, s, m, alpha, beta, fin)
        for got, want in ((z_next, jz_next), (v_new, jv_new)):
            want = np.asarray(want.astype(jnp.float32))
            lim = 4 * np.spacing(np.float32(np.abs(z).max())) if dtype == "float32" else 0.0
            assert np.abs(got.float().numpy() - want).max() <= lim


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_probe_rank_form_matches_the_reference(dtype):
    """K8's rank form on two slices of rows, against the global mean: the
    slices' drift sums added in float64 within rtol 1e-6 of the reference's
    ``plane_probe``, the scale alike on both slices."""
    from repro_torch.kernels.anchor_mix.ref import worker_mean
    from repro_torch.kernels.consensus_probe import ops

    m, n = 4, 300
    x = np.random.default_rng(5).normal(size=(m, n)).astype(np.float32)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jd, js = jprobe_ref.plane_probe(jnp.asarray(x).astype(getattr(jnp, dtype)))
    xbar = worker_mean(tx.float())
    parts = [ops.probe_rows(tx[c], xbar) for c in _slices(m)]
    assert all(p.dtype == torch.float64 for p in parts) and torch.equal(parts[0][1], parts[1][1])
    np.testing.assert_allclose(float(parts[0][0] + parts[1][0]), float(jd), rtol=1e-6)
    np.testing.assert_allclose(float(parts[0][1]), float(js), rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_the_weighted_finish_returns_an_anchor_of_its_own(dtype):
    """The finished anchor of a weighted sum is round(S) in a buffer of its
    own: the same launch overwrites S with the rows' partial sum."""
    from repro_torch.kernels.anchor_mix import ops

    rng = np.random.default_rng(11)
    tdt = getattr(torch, dtype)
    x = torch.from_numpy(rng.normal(size=(2, 64)).astype(np.float32)).to(tdt)
    z = torch.from_numpy(rng.normal(size=64).astype(np.float32)).to(tdt)
    s = torch.from_numpy(rng.normal(size=64).astype(np.float32))
    want = s.to(tdt, copy=True)
    got = ops.pullback_rank(x, z, None, s, 4, 0.6, None, 2, weights=torch.tensor([0.5, 0.0]))
    assert torch.equal(got, want) and not torch.equal(s.to(tdt), want)
