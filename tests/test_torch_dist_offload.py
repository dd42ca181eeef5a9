"""Host offload on worker ranks (``AlgoConfig(offload=True)`` under a
``mesh_context``), on the CPU over gloo.

The ranks run ``tests/torch_dist_ranks.py::run_path_case`` in one spawn of
two ranks for every case, importing no JAX; the one-process port (offloaded
and resident) and the JAX package's offloaded fit run here, on the same
weights (the reference's built state, carried across as numpy), batches,
plan and controller. The small classification task (2,000 samples, 500 held
out), τ 2 (delayed averaging: delay 1, consumed mid-round), 3 rounds, chunks
of 1/64 MiB (several chunks a bucket); each rank streams the optimizer state
of its rows from its own host stacks, and the rank in-flight kinds keep
their anchor-shaped planes on the host between boundaries. On the CPU the
stacks are plain tensors and the copies synchronous, so the run checks the
placement logic and the values, not the overlap. Stated bounds and why:

* two ranks of one row each (m 2) against the one-process offloaded port
  and against the one-process resident port: **bit for bit** — losses,
  every array of the drained state (x, the optimizer state of the rows,
  vars, the in-flight value), the readers. Every worker sum is of two f32
  terms, which commutes, and the streamed step is elementwise. Every
  strategy with a rank boundary, by name and by alias, with SGD in f32;
  Overlap-Local-SGD (β 0.7 and 0), CoCoD, sparse_anchor, gossip_ring and
  PowerSGD also with AdamW and in bf16; Overlap-Local-SGD (β 0.7) under a
  crash plan, adaptive τ and both, Local SGD (the live mean over the
  ranks), CoCoD, sparse_anchor and gossip_ring under the crash plan (the
  re-sync reads a device copy of the host anchor; the fault log and the τ
  schedule equal; the probe's drift and scale within rtol 1e-6, the ranks
  adding their drift in float64);
* four workers on two ranks of two rows: every array within 2(m − 1) f32
  ulps of its largest magnitude, as ``tests/test_torch_dist_fit.py`` states
  (a worker sum of four terms added in another order), losses within
  rtol 1e-5. The anchor momentum v = β·v + (mean − z) and sparse_anchor's
  error feedback e are differences of anchors, and the reordered sum's
  rounding is on the mean: their bound is in ulps of the anchor z's largest
  magnitude;
* the drain is idempotent: twice on one state gives the same arrays, and
  a drained state drains to itself; a resident rank state, drained, is
  adopted by the offloaded engine and trains bit for bit as the resident
  one (one rank in this process);
* a checkpoint of an offloaded rank state: the two ranks' file is the
  one-process offloaded run's file byte for byte (the row-stacked host
  planes gathered one chunk at a time), restores on the ranks (W 2) and in
  one process (W 1) bitwise, one more round after it bitwise the
  one-process round; a one-process m 2 file onto the ranks at m 4 with
  ``elastic=True`` equals the one-process elastic restore;
* the JAX package's offloaded fit of Overlap-Local-SGD (β 0.7) against the
  ranks: losses within rtol 1e-4, ``tests/test_torch_dist_fit.py``'s bound.
"""
import jax
import numpy as np
import pytest
import torch

import torch_dist_ranks as ranks
from repro.api import ClassificationSpec as JSpec
from repro.api import Experiment as JExperiment
from repro.config import AlgoConfig as JAlgo

SMALL = dict(n=2000, holdout=500)
CHUNK_MB = 1 / 64
STRATS = {"overlap": {"anchor_beta": 0.7}, "overlap_beta0": {"anchor_beta": 0.0}, "local_sgd": {"name": "local_sgd"},
          "sync_sgd": {"name": "sync_sgd"}, "easgd": {"name": "easgd"}, "cocod": {"name": "cocod"},
          "delayed_avg": {"name": "delayed_avg", "delay_steps": 1},
          "sparse_anchor": {"name": "sparse_anchor", "sparse_k": 0.25}, "powersgd": {"name": "powersgd"},
          "gossip_full": {"name": "gossip_full"}, "gossip_ring": {"name": "gossip_ring"},
          "gossip_exp": {"name": "gossip_exp"}, "gossip_pushsum": {"name": "gossip_pushsum", "topology": "ring"},
          # the aliases
          "alias-overlap": {"name": "overlap", "anchor_beta": 0.7}, "alias-dasgd": {"name": "dasgd", "delay_steps": 1},
          "alias-loscar": {"name": "loscar", "sparse_k": 0.25}, "alias-sgp": {"name": "sgp", "topology": "exp"}}
WIDE = ("overlap", "overlap_beta0", "cocod", "sparse_anchor", "gossip_ring", "powersgd")
CTRL = dict(tau=1, tau_min=1, tau_max=4, lo=0.05, hi=0.5)
PLANS = {2: ("crash:1@1-2", 7), 4: ("crash:1@1-2,slow:2x4", 7)}
MODES = {"plain": (False, False), "faults": (True, False), "adaptive": (False, True), "both": (True, True)}
M2 = [(s, "sgd", "float32", "plain") for s in STRATS]
M2 += [(s, o, d, "plain") for s in WIDE for o, d in (("adamw", "float32"), ("sgd", "bfloat16"), ("adamw", "bfloat16"))]
M2 += [("overlap", "sgd", "float32", mode) for mode in ("faults", "adaptive", "both")]
M2 += [(s, "sgd", "float32", "faults") for s in ("local_sgd", "cocod", "sparse_anchor", "gossip_ring")]
M4 = [("overlap", "sgd", "float32", "faults"), ("overlap", "adamw", "float32", "plain"),
      ("cocod", "sgd", "float32", "plain"), ("sparse_anchor", "sgd", "float32", "plain"),
      ("gossip_ring", "sgd", "float32", "plain"), ("powersgd", "sgd", "float32", "plain")]
CKPT = [("overlap", "float32"), ("overlap", "bfloat16"), ("cocod", "float32"), ("sparse_anchor", "float32"),
        ("gossip_ring", "float32"), ("powersgd", "float32")]
ELASTIC = ["overlap", "gossip_ring"]
M4_ULPS = 2 * (4 - 1)
SCHEDULE_KEYS = ("round", "tau", "decision", "next_tau", "fault")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_P = {}


def _params():
    if "p" not in _P:
        j = JExperiment(task=JSpec(**SMALL), workers=2).build()
        _P["p"] = jax.tree.map(lambda a: np.asarray(a, np.float32), j.params)
    return _P["p"]


def _case(strat, opt, dtype, mode, m, offload=True, **kw):
    faults, adaptive = MODES[mode]
    return dict(dict(path=True, strategy=dict(STRATS[strat], tau=2, offload=offload, offload_chunk_mb=CHUNK_MB),
                     optimizer=opt, dtype=dtype, m=m, params=_params(), rounds=3, plan=PLANS[m] if faults else None,
                     ctrl=CTRL if adaptive else None), **kw)


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """The one-process files the ranks restore, then every case on two gloo
    ranks in one spawn. Returns (named cases, per-rank results by name, the
    directory)."""
    where = tmp_path_factory.mktemp("dist_offload")
    cases = {}
    for c in M2:
        cases["m2-" + "-".join(c)] = _case(*c, 2)
    for c in M4:
        cases["m4-" + "-".join(c)] = _case(*c, 4)
    for strat, dtype in CKPT:
        cases[f"save-{strat}-{dtype}"] = _case(strat, "sgd", dtype, "plain", 2, save=True, more=1, dir=str(where))
    for strat in ELASTIC:  # the one-process m 2 file onto m 4
        cases[f"elastic-{strat}"] = _case(strat, "sgd", "float32", "plain", 4, rounds=0, elastic=True, more=1,
                                          dir=str(where), restore=str(where / f"save-save-{strat}-float32-one.npz"))
    for name, case in cases.items():
        case["name"] = name
    for strat in ELASTIC:  # the files the elastic cases read
        ranks.run_path_case(cases[f"save-{strat}-float32"])
    per_rank = ranks.spawn(where, list(cases.values()), 2)
    return cases, {name: [res[i] for res in per_rank] for i, name in enumerate(cases)}, where


def _equal(a: dict, b: dict, what):
    assert sorted(a) == sorted(b), what
    for key in a:
        assert ranks.same_bytes(a[key], b[key]), (what, key)


def _schedule(sched):
    return None if sched is None else [{k: h.get(k) for k in SCHEDULE_KEYS} for h in sched]


def _readers_equal_on_ranks(per_rank):
    for res in per_rank[1:]:
        assert res["loss"] == per_rank[0]["loss"] and res["evaluate"] == per_rank[0]["evaluate"]
        assert all(ranks.same_bytes(a, b) for a, b in zip(res["consensus"], per_rank[0]["consensus"]))
        assert res["tau_schedule"] == per_rank[0]["tau_schedule"] and res["fault_log"] == per_rank[0]["fault_log"]


def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


# -- two ranks of one row: the one-process port bit for bit, offloaded and resident --------------


@pytest.mark.parametrize("case_id", ["-".join(c) for c in M2])
def test_two_ranks_offloaded_fit_is_the_one_process_fit_bit_for_bit(spawned, case_id):
    cases, results, _ = spawned
    case, per_rank = cases["m2-" + case_id], results["m2-" + case_id]
    _readers_equal_on_ranks(per_rank)
    got = per_rank[0]
    assert all(res["drain_idempotent"] for res in per_rank)
    assert got["anchor_plane"] == "raises"  # the anchor z is host-resident, as on one process
    for offload in (True, False):
        one = ranks.run_path_case(dict(case, strategy=dict(case["strategy"], offload=offload)))
        assert got["loss"] == one["loss"], offload
        assert got["fault_log"] == one["fault_log"] and got["steps"] == one["steps"]
        assert _schedule(got["tau_schedule"]) == _schedule(one["tau_schedule"])
        if one["tau_schedule"] is not None:
            for name in ("drift", "scale"):
                np.testing.assert_allclose([h[name] for h in got["tau_schedule"]],
                                           [h[name] for h in one["tau_schedule"]], rtol=1e-6)
        _equal(ranks.gathered(per_rank), one["state"], (case_id, offload))
        assert all(ranks.same_bytes(a, b) for a, b in zip(got["consensus"], one["consensus"]))
        assert got["evaluate"] == one["evaluate"]


# -- four workers on two ranks of two rows --------------------------------------------------------


@pytest.mark.parametrize("case_id", ["-".join(c) for c in M4])
def test_four_workers_on_two_ranks_within_bounds(spawned, case_id):
    cases, results, _ = spawned
    case, per_rank = cases["m4-" + case_id], results["m4-" + case_id]
    _readers_equal_on_ranks(per_rank)
    one = ranks.run_path_case(case)
    got = per_rank[0]
    assert got["fault_log"] == one["fault_log"] and got["steps"] == one["steps"]
    np.testing.assert_allclose(got["loss"], one["loss"], rtol=1e-5)
    have, want = ranks.gathered(per_rank), one["state"]
    assert sorted(have) == sorted(want)
    worst = 0.0
    for key, w in want.items():
        if not np.issubdtype(w.dtype, np.floating) or w.size == 0:
            assert ranks.same_bytes(have[key], w), key
            continue
        ulp = np.spacing(np.float32(ranks.magnitude(want, key)))
        err = float(np.abs(have[key].astype(np.float64) - w).max())
        worst = max(worst, err / ulp)
        assert err <= M4_ULPS * ulp, (key, err / ulp)
    print(f"observed: {worst:.0f} f32 ulps of the largest magnitude")


# -- checkpoints of an offloaded rank state --------------------------------------------------------


@pytest.mark.parametrize("strat,dtype", CKPT, ids=["-".join(c) for c in CKPT])
def test_offloaded_rank_checkpoint_round_trips(spawned, strat, dtype):
    """The ranks' file is the one-process offloaded file byte for byte; it
    restores on the ranks (W 2) and in one process (W 1) bitwise, and one
    more round after it is the one-process round."""
    from repro_torch import checkpoint
    from repro_torch.training import drain

    cases, results, where = spawned
    name = f"save-{strat}-{dtype}"
    per_rank = results[name]
    one = ranks.run_path_case(cases[name])
    got, want = _npz(where / f"save-{name}-mesh.npz"), _npz(where / f"save-{name}-one.npz")
    _equal(got, want, name)
    assert any(k.startswith("opt::") for k in got)
    saved = ranks.gathered(per_rank)
    _equal(ranks.gathered(per_rank, "restored"), saved, (name, "W 2"))
    _equal(ranks.gathered(per_rank, "end"), one["end"], (name, "W 2 end"))
    assert per_rank[0]["loss"] == one["loss"]
    exp = ranks._experiment(cases[name])  # W 1: the ranks' file into one process
    for _ in range(cases[name]["rounds"] * exp.tau):  # the batch stream where the ranks' run saved
        exp.next_batch()
    exp.state = checkpoint.restore(str(where / f"save-{name}-mesh.npz"), exp.state)
    _equal(ranks._flat_state(exp.state)[0], saved, (name, "W 1"))
    exp.fit(rounds=1)
    _equal(ranks._flat_state(drain(exp.state))[0], one["end"], (name, "W 1 end"))


@pytest.mark.parametrize("strat", ELASTIC)
def test_one_process_file_onto_more_workers_on_ranks(spawned, strat):
    """A one-process m 2 offloaded file onto two ranks at m 4
    (``elastic=True``: the stacks' worker axis grown, new rows from row 0)
    equals the one-process elastic restore, and the round after it agrees
    within the m 4 bound."""
    cases, results, _ = spawned
    name = f"elastic-{strat}"
    one = ranks.run_path_case(cases[name])
    _equal(ranks.gathered(results[name], "restored"), one["restored"], name)
    x = ranks.gathered(results[name], "restored")["x::0"]
    assert x.shape[0] == 4 and np.array_equal(x[2], x[0])
    np.testing.assert_allclose(results[name][0]["loss"], one["loss"], rtol=1e-5)


# -- a drained resident rank state adopted by the offloaded engine -------------------------


@pytest.fixture
def one_rank(tmp_path):
    """A one-rank gloo group in this process, destroyed afterwards."""
    import datetime

    import torch.distributed as dist

    from repro_torch.launch.mesh import make_smoke_mesh

    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rendezvous'}", world_size=1, rank=0,
                            timeout=datetime.timedelta(seconds=60))
    try:
        yield make_smoke_mesh(1, device="cpu")
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("name", ["overlap_local_sgd", "cocod", "gossip_ring"])
def test_drained_resident_rank_state_is_adopted_offloaded(one_rank, name):
    """A resident state on a rank, trained a round and drained, handed to
    the offloaded engine: its optimizer state moves to host stacks at the
    next round and the run stays bit for bit the resident run's."""
    from repro_torch.config import AlgoConfig, OptimizerConfig
    from repro_torch.core import make_strategy
    from repro_torch.models import classifier as clf
    from repro_torch.optim import from_config, schedules
    from repro_torch.parallel import offload as off
    from repro_torch.parallel.sharding import mesh_context
    from repro_torch.training import drain, make_round_step, make_train_state

    params = clf.init_mlp(torch.Generator().manual_seed(0), 8, 3, hidden=(16,))
    opt = from_config(OptimizerConfig())
    gen = torch.Generator().manual_seed(1)
    batches = [(torch.randn(2, 2, 4, 8, generator=gen), torch.randint(0, 3, (2, 2, 4), generator=gen,
                                                                      dtype=torch.int32)) for _ in range(3)]
    runs = {}
    with mesh_context(one_rank):
        for offload in (False, True):
            resident = make_strategy(AlgoConfig(name=name, tau=2))
            state = make_train_state(params, 2, opt, resident)
            state = drain(make_round_step(clf.mlp_loss, opt, resident, schedules.constant(0.1))(state, batches[0])[0])
            strat = make_strategy(AlgoConfig(name=name, tau=2, offload=offload, offload_chunk_mb=1 / 256))
            step = make_round_step(clf.mlp_loss, opt, strat, schedules.constant(0.1))
            for b in batches[1:]:
                state = step(state, b)[0]
            state = drain(state)
            assert off.is_offloaded(state.opt) == offload
            runs[offload] = ranks._flat_state(state)[0]
    _equal(runs[True], runs[False], name)


# -- the JAX reference ---------------------------------------------------------------------------


def test_two_ranks_offloaded_fit_matches_jax(spawned):
    cases, results, _ = spawned
    got = results["m2-overlap-sgd-float32-plain"][0]
    j = JExperiment(task=JSpec(**SMALL), workers=2,
                    strategy=JAlgo(anchor_beta=0.7, tau=2, offload=True, offload_chunk_mb=CHUNK_MB)).build()
    jres = j.fit(rounds=3)
    np.testing.assert_allclose(got["loss"], [float(v) for v in jres.losses], rtol=1e-4)
    assert np.isfinite(got["loss"]).all()
