"""Every strategy on worker ranks: the gossip family over a neighbour
exchange (K5's gossip rank form), sparse_anchor and PowerSGD, through
``Experiment.fit`` over ``torch.distributed`` (gloo CPU ranks) with faults,
adaptive τ and both; the neighbour schedule (``core.topology.rank_peers``)
and the plain K5 rank form against the stacked gossip boundary.

The ranks run ``tests/torch_dist_ranks.py::run_fit_case`` in one spawn of
two ranks (every case, m 2 and m 4), importing no JAX and holding the
host's gossip phase against the device counter at every drain; the
one-process port and the JAX package's ``Experiment.fit`` run here, on the
same weights (the reference's built state, carried across as numpy),
batches, plan and controller. The small classification task (2,000
samples, 500 held out), τ 2 (PowerSGD: 1), 3 rounds; the plan
``crash:1@1-2`` at m 2 and ``crash:1@1-2,slow:2x4`` at m 4 (seed 7), the
controller τ 1 in [1, 4], band [0.05, 0.5]. The strategies: gossip_ring,
gossip_exp, sgp over the ring (``gossip_pushsum``), gossip_full (K4's rank
form), sparse_anchor at k 0.25 and powersgd. Stated bounds and why:

* two ranks of one row each (m 2) against the one-process port at m 2,
  f32 and bf16: **bit for bit** — losses, x, the momentum, vars (the gossip
  w and t, sparse_anchor's z and error e, PowerSGD's q and its error rows),
  the drained in-flight value (the gossip mix and its push weights, the
  anchor), the fault log, the τ schedule's rounds, τs and decisions, and
  the readers, which are also equal on both ranks. The gossip mix sums the
  held rows in the stacked push's order; every worker sum is of two f32
  terms, which commutes. The probe's drift and scale within rtol 1e-6 (the
  ranks add their drift squares in float64);
* the same ranks against the JAX package's fits: the fault log and the τ
  schedule's decisions exactly, losses rtol 1e-4 (sparse_anchor: 1e-3, the
  bound of ``tests/test_torch_strategies.py``'s fits, held against the
  reference's per-leaf ``sparsify_topk`` oracle, ``packed=False``; bf16:
  1e-3), drift and scale rtol 1e-5 (bf16: 1e-3);
* four workers on two ranks of two rows against the one-process port at m
  4: the fault log and the schedule's decisions exactly, every plane within
  2(m − 1) f32 ulps of its largest magnitude (``M4_ULPS``: a worker sum of
  four terms is the ranks' two partial sums added, not rows 0 .. 3 in
  order) and the losses within rtol 1e-5, the readers equal on both ranks.
  The gossip planes come out bit for bit there too (a mix reads whole
  rows, no partial sum), the readers' consensus (a sum over the ranks) not;
* a probed round's collectives: one extra n-wide f32 all-reduce and one
  float64 scalar a round, as for the strategies of ``test_torch_dist_fit``;
  the gossip exchange is point to point and adds none;
* the plain K5 rank form on slices of rows against the stacked boundary
  (``ref.gossip_boundary``): the rows bit for bit, and the drain's mix bit
  for bit the stacked in-flight mix; against the reference's boundary
  (JAX) within 4 f32 ulps of max|x| (bf16: one ulp): XLA's push sums in
  its own order.
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
from repro.core import topology as jtopology
from repro.data.loaders import classification_batch_fn as jbatch_fn
from repro.fault import FaultPlan as JFaultPlan
from repro.kernels.anchor_mix import ref as janchor_ref
from repro.training import make_train_state as jmake_train_state
from repro_torch.config import AlgoConfig
from repro_torch.core import make_strategy
from repro_torch.core.topology import cached_topology, rank_peers

SRC = Path(__file__).resolve().parents[1] / "src"
HELPER = Path(__file__).with_name("torch_dist_ranks.py")
_TIMEOUT = int(os.environ.get("REPRO_SUBPROC_TIMEOUT", "300"))
SMALL = dict(n=2000, holdout=500)
ROUNDS = 3
CASES = {"gossip_ring": {"name": "gossip_ring"}, "gossip_exp": {"name": "gossip_exp"},
         "sgp_ring": {"name": "gossip_pushsum", "topology": "ring"}, "gossip_full": {"name": "gossip_full"},
         "sparse_anchor": {"name": "sparse_anchor", "sparse_k": 0.25}, "powersgd": {"name": "powersgd"}}
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
    once a strategy, dtype and m); sparse_anchor's is the per-leaf oracle."""
    key = (strat, dtype, m)
    if key not in _JAX:
        fields = dict(_strategy(strat), packed=False) if strat == "sparse_anchor" else _strategy(strat)
        j = JExperiment(task=JSpec(**SMALL), strategy=JAlgo(**fields), workers=m).build()
        if dtype == "bfloat16":
            jparams = jax.tree.map(lambda a: a.astype(jnp.bfloat16), j.params)
            j.state = jmake_train_state(jparams, m, j.opt_obj, j.strategy_obj, j.axes)
        _JAX[key] = (j, j.state)
    return _JAX[key]


def _reference_q():
    """The reference's PowerSGD starting factors in the layout's leaf order
    (the port draws its own from the same seed, other bits)."""
    from repro_torch.parallel.packing import tree_flatten

    qs, _ = tree_flatten(jax.tree.map(np.asarray, _jax_experiment("powersgd", "float32", 2)[1].vars.extra.q))
    return [None if q is None else np.asarray(q, np.float32) for q in qs]


def _case(strat, dtype, mode, m, params):
    faults, adaptive = MODES[mode]
    return dict(fit=True, strategy=_strategy(strat), dtype=dtype, m=m, rounds=ROUNDS, params=params,
                plan=PLANS[m] if faults else None, ctrl=CTRL if adaptive else None,
                q=_reference_q() if strat == "powersgd" else None)


def _jax_fit(case, strat):
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
    j = JExperiment(task=JSpec(**SMALL), workers=2).build()
    params = jax.tree.map(lambda a: np.asarray(a, np.float32), j.params)
    cases = [_case(*c, 2, params) for c in W2] + [_case(*c, 4, params) for c in M4]
    where = tmp_path_factory.mktemp("dist_gossip") / "w2"
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


ROWS = ("x", "momentum", "vars_rows", "inflight_mix")
REPLICATED = ("vars", "inflight", "inflight_w", "consensus", "consensus_plane", "anchor_plane")


def _readers_equal_on_ranks(per_rank):
    for key in REPLICATED:
        if key in per_rank[0]:
            assert all(_equal(res[key], per_rank[0][key]) for res in per_rank[1:]), key
    assert all(res["evaluate"] == per_rank[0]["evaluate"] for res in per_rank)
    for res in per_rank[1:]:
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
    strat = W2[idx][0]
    jres = _jax_fit(case, strat)
    got = per_rank[0]
    bf16 = case["dtype"] == "bfloat16"
    assert got["fault_log"] == jres.fault_log
    assert got["steps"] == jres.steps
    assert _schedule(got["tau_schedule"]) == _schedule(jres.tau_schedule)
    if jres.tau_schedule is not None:
        for name in ("drift", "scale"):
            np.testing.assert_allclose([h[name] for h in got["tau_schedule"]],
                                       [h[name] for h in jres.tau_schedule], rtol=1e-3 if bf16 else 1e-5)
    rtol = 1e-3 if bf16 or strat == "sparse_anchor" else 1e-4
    np.testing.assert_allclose(got["loss"], jres.losses, rtol=rtol)
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


# -- one rank holding every row (the one-card NCCL shape) -----------------------------------


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


@pytest.mark.parametrize("strat", ["gossip_ring", "gossip_exp", "sparse_anchor", "powersgd"])
def test_one_rank_holding_every_row_is_the_stacked_fit(one_rank, strat):
    """W 1, m 4: the rank forms on all m rows (the exchange moves nothing;
    every held row is the rank's own) equal the stacked fit bit for bit,
    under the fault plan and the controller; the drain's host phase checked
    against the device counter."""
    from repro_torch.core.strategy import RankGossipInflight
    from repro_torch.parallel.sharding import exchange_transport, mesh_context

    j = JExperiment(task=JSpec(**SMALL), workers=2).build()
    params = jax.tree.map(lambda a: np.asarray(a, np.float32), j.params)
    case = _case(strat, "float32", "both", 4, params)
    RankGossipInflight.check_phase = True
    try:
        with mesh_context(one_rank):
            assert exchange_transport() == "none"
            got = ranks.run_fit_case(case)
    finally:
        RankGossipInflight.check_phase = False
    one = ranks.run_fit_case(case)
    assert sorted(got) == sorted(one)
    assert got["loss"] == one["loss"] and got["fault_log"] == one["fault_log"]
    for key in ROWS + REPLICATED:
        if key in one:
            assert _equal(got[key], one[key]), key


# -- a probed round's collectives ----------------------------------------------------------


@pytest.mark.parametrize("strat", list(CASES))
@pytest.mark.parametrize("masked", [False, True], ids=["live", "masked"])
def test_a_probed_round_adds_one_plane_wide_collective(one_rank, strat, masked):
    """The all-reduces of three boundaries on a rank, unprobed and probed:
    the probe adds one n-wide f32 sum (x̄) and one float64 sum of the
    buckets' drift a boundary; the exchange adds no all-reduce."""
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
    assert sorted(extra) == sorted([("torch.float32", n)] * 3 + [("torch.float64", 1)] * 3), extra
    if strat.startswith(("gossip_ring", "gossip_exp", "sgp")):
        assert counts[False] == []  # the push is a neighbour exchange


# -- the neighbour schedule ----------------------------------------------------------------


@pytest.mark.parametrize("name", ["full", "ring", "exp"])
@pytest.mark.parametrize("m,W", [(2, 2), (4, 2), (4, 4), (8, 2), (8, 4), (6, 3), (5, 1)])
def test_rank_peers_are_the_topologys_edges_between_ranks(name, m, W):
    """Every edge j → i of ``in_mask(phase)`` (the reference's topology)
    with j and i on different ranks is one row that j's rank sends to i's
    and i's rank receives from j's; nothing else moves. The held rows of a
    rank are its own and the received ones."""
    topo = cached_topology(name, m)
    jtopo = jtopology.make_topology(name, m)
    np.testing.assert_array_equal(topo.mats, jtopo.mats)
    per = m // W
    for phase in range(topo.num_phases + 1):
        peers = rank_peers(topo, m, W, phase)
        mask = jtopo.in_mask(phase)
        want_send = {(q, p): set() for q in range(W) for p in range(W)}
        for i in range(m):
            for j in range(m):
                if mask[i, j] and i // per != j // per:
                    want_send[(j // per, i // per)].add(j)
        for q, pq in enumerate(peers):
            assert pq.rows == (q * per, (q + 1) * per)
            got_send = {p: set(rows) for p, rows in pq.send}
            got_recv = {p: set(rows) for p, rows in pq.recv}
            for p in range(W):
                assert got_send.get(p, set()) == want_send[(q, p)]
                assert got_recv.get(p, set()) == want_send[(p, q)]
            assert set(pq.held) == set(range(*pq.rows)) | set(pq.received)
    with pytest.raises(ValueError, match="ranks"):
        rank_peers(topo, m, W + 1 if m % (W + 1) else W + 2, 0)


# -- the plain K5 rank form against the stacked boundary on slices of rows ------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["ring", "exp"])
@pytest.mark.parametrize("phase", [0, 1])
def test_gossip_rank_form_on_row_slices_matches_the_stacked_boundary(dtype, name, phase):
    """m 4 on two ranks of two rows: boundary k+1 of each rank's rows from
    the launch-time rows x' (its own and those ``rank_peers`` brings) with
    boundary k's Peff, against the stacked boundary consuming mix_k =
    round(Peff_k @ x') (``ref.gossip_boundary``): the rows bit for bit, a
    held row (live 0) and a row with no push mass (wsafe 1, live 0) passing
    through; the drain (mode 2) bit for bit mix_k's rows; the rows against
    the reference's boundary (JAX: the debias, ``anchor_mix``, the einsum
    push) within 4 f32 ulps (bf16: one ulp) of max|x|."""
    from repro_torch.kernels.anchor_mix import ref

    m, W, n, alpha = 4, 2, 301, 0.6
    rng = np.random.default_rng(7 + phase)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    topo = cached_topology(name, m)
    w = rng.uniform(0.6, 1.0, m).astype(np.float32)
    P = topo.matrix(phase) * w[None, :]
    x = torch.from_numpy(rng.normal(size=(m, n)).astype(np.float32)).to(tdt)
    xl = torch.from_numpy(rng.normal(size=(m, n)).astype(np.float32)).to(tdt)  # launch-time rows x'
    peff = torch.from_numpy(P.astype(np.float32))
    wmix = peff.sum(1)
    live = torch.tensor([1.0, 0.0, 1.0, 0.0])  # row 1 held out; row 3 received no mass
    wsafe = wmix.clone()
    wsafe[3] = 1.0
    mix = ref.push(peff, xl).to(tdt)
    x_want, _ = ref.gossip_boundary(x, mix, wsafe, live, peff, alpha)
    rows, mixes = [], []
    for q, pq in enumerate(rank_peers(topo, m, W, phase)):
        lo, hi = pq.rows
        recv = xl[list(pq.received)] if pq.received else None
        x_q, own_q = ref.gossip_rank(x[lo:hi], xl[lo:hi], recv, pq.held, pq.received, lo, peff, wsafe[lo:hi],
                                     live[lo:hi], alpha, 0)
        assert torch.equal(own_q, x_q)
        rows.append(x_q)
        _, mix_q = ref.gossip_rank(x[lo:hi], xl[lo:hi], recv, pq.held, pq.received, lo, peff, wsafe[lo:hi],
                                   live[lo:hi], alpha, 2)
        mixes.append(mix_q)
    got = torch.cat(rows)
    assert torch.equal(got, x_want)
    assert torch.equal(got[[1, 3]], x[[1, 3]])
    assert torch.equal(torch.cat(mixes), mix)
    # the reference's boundary: its debias, anchor_mix and einsum push
    jmix = jnp.einsum("ij,j...->i...", jnp.asarray(P), jnp.asarray(xl.float().numpy()).astype(jdt).astype(jnp.float32))
    jmix = jmix.astype(jdt)
    jz = (jmix.astype(jnp.float32) / jnp.asarray(wsafe.numpy())[:, None]).astype(jdt)
    jx = janchor_ref.anchor_mix(jnp.asarray(x.float().numpy()).astype(jdt), jz, alpha)
    jx = jnp.where(jnp.asarray(live.numpy() > 0)[:, None], jx, jnp.asarray(x.float().numpy()).astype(jdt))
    want = np.asarray(jx.astype(jnp.float32))
    top = np.float32(np.abs(want).max())
    lim = 4 * np.spacing(top) if dtype == "float32" else float(2.0 ** (np.floor(np.log2(top)) - 7))
    assert np.abs(got.float().numpy() - want).max() <= lim
    # mode 1: own holds the finished mix
    lo, hi = 0, 2
    x_q, _ = ref.gossip_rank(x[lo:hi], mix[lo:hi], None, (0, 1), (), lo, peff, wsafe[lo:hi], live[lo:hi], alpha, 1)
    assert torch.equal(x_q, x_want[lo:hi])


def test_gossip_rank_wrapper_checks_its_operands():
    from repro_torch.kernels.anchor_mix import ops

    x = torch.zeros(2, 8)
    peff, w = torch.eye(4), torch.ones(2)
    with pytest.raises(ValueError, match="held"):
        ops.gossip_rank_(x, x.clone(), None, (0, 1, 3), (), 0, peff, w, w, 0.5)
    with pytest.raises(ValueError, match="float32"):
        ops.gossip_rank_(x, x.clone(), None, (0, 1), (), 0, peff.double(), w, w, 0.5)
    x2, own = ops.gossip_rank_(x, torch.ones(2, 8), None, (0, 1), (), 0, peff, w, w, 0.5, mode=1)
    assert torch.equal(x2, torch.full((2, 8), 0.5)) and torch.equal(own, x2)


# -- the sparse step's quantile past the sort's size ---------------------------------------


@pytest.mark.parametrize("n", [1, 2, 7, 1000, 4099])
@pytest.mark.parametrize("q", [0.0, 0.25, 0.75, 0.9, 1.0])
def test_order_statistic_search_is_the_sort(monkeypatch, n, q):
    """The sparse step's quantile of the magnitudes by the bit-pattern
    search (leaves past 2^24 elements) equals the sorted one bit for bit:
    ties, zeros, subnormals and a single value included."""
    from repro_torch.core import strategy

    rng = np.random.default_rng(n)
    a = np.abs(rng.normal(size=n)).astype(np.float32)
    a[: n // 5] = a[0]  # ties
    a[n // 5 : n // 4] = 0.0
    a[n // 4 : n // 3] = np.float32(1e-42)  # subnormal
    t = torch.from_numpy(rng.permutation(a))
    want = strategy._quantile_linear(t, q)
    monkeypatch.setattr(strategy, "_SORT_MAX", 0)
    got = strategy._quantile_linear(t, q)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert np.array_equal(got.numpy().view(np.int32), want.numpy().view(np.int32))
