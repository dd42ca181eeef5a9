"""The per-leaf path on worker ranks (``AlgoConfig(packed=False)``, the
legacy ``Algorithm`` shims, a packed strategy with an optimizer that has no
packed step, under a ``mesh_context``), on the CPU over gloo.

The ranks run ``tests/torch_dist_ranks.py::run_path_case`` in one spawn of
two ranks for every case, importing no JAX; the one-process per-leaf port
and the JAX package's per-leaf fit run here, on the same weights (the
reference's built state, carried across as numpy), batches, plan and
controller. x is a dict of the rank's (r, ...) leaves; the per-leaf math
stays per leaf and only the worker reductions are collectives (one flat f32
buffer of every leaf's rows' partial sums, one all-reduce). The small
classification task (2,000 samples, 500 held out), τ 2 (delayed averaging:
delay 1, consumed mid-round), 3 rounds. Stated bounds and why:

* two ranks of one row each (m 2) against the one-process per-leaf port:
  **bit for bit** — losses, every array of the drained state (x's leaves,
  the per-leaf optimizer state with the per-worker Adam count, vars, the
  in-flight value), the readers. Every worker sum is of two f32 terms,
  which commutes. Every strategy by name and by alias with SGD in f32;
  Overlap-Local-SGD (β 0.7 and 0), CoCoD, sparse_anchor, gossip_ring and
  PowerSGD also with AdamW and in bf16; Overlap-Local-SGD (β 0.7) under a
  crash plan, adaptive τ and both, and gossip_ring, sparse_anchor, delayed
  averaging, Local SGD and EASGD under both (the probe's drift and scale
  within rtol 1e-6: the ranks add their drift in float64, the one-process
  per-leaf probe in PyTorch's order); the legacy shims (Overlap-Local-SGD
  β 0.7 and 0, Local SGD, sync-SGD, EASGD, CoCoD, PowerSGD; Overlap-Local-SGD
  also under adaptive τ); a packed strategy with an optimizer stripped of
  its packed step (Overlap-Local-SGD with SGD and AdamW, delayed averaging,
  PowerSGD, gossip_ring, sync-SGD);
* the same per-leaf runs against the packed rank path (the same strategy,
  packed, on the same two ranks): **bit for bit** — losses, x's leaves, the
  readers (the per-leaf and packed boundaries are op for op one another on
  one device, ``tests/test_torch_perleaf.py``); the legacy
  Overlap-Local-SGD and sync-SGD shims too;
* four workers on two ranks of two rows: every array within 2(m − 1) f32
  ulps of its largest magnitude (v and e, differences of anchors, in ulps
  of the anchor z's), as ``tests/test_torch_dist_offload.py`` states;
  losses within rtol 1e-5;
* the drain is idempotent;
* checkpoints of per-leaf rank states: the two ranks' file is the
  one-process per-leaf file byte for byte (the row-stacked leaves gathered,
  the per-worker Adam count among them), restores on the ranks (W 2) and
  in one process (W 1) bitwise, one more round after it bitwise; a
  one-process m 2 file onto the ranks at m 4 with ``elastic=True`` equals
  the one-process elastic restore;
* the JAX package's per-leaf fit of Overlap-Local-SGD (β 0.7) against the
  ranks: losses within rtol 1e-4, ``tests/test_torch_dist_fit.py``'s bound;
* on one rank in this process: a legacy shim refuses a membership as it
  does off a mesh, and a per-leaf LM (the reduced qwen2-7b) reads its
  consensus (bit for bit the one-process one) and serves it.
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
LEGACY = ("overlap", "overlap_beta0", "local_sgd", "sync_sgd", "easgd", "cocod", "powersgd")
LEAFY = (("overlap", "sgd"), ("overlap", "adamw"), ("delayed_avg", "sgd"), ("powersgd", "sgd"), ("gossip_ring", "sgd"),
         ("sync_sgd", "sgd"))
CTRL = dict(tau=1, tau_min=1, tau_max=4, lo=0.05, hi=0.5)
PLANS = {2: ("crash:1@1-2", 7), 4: ("crash:1@1-2,slow:2x4", 7)}
MODES = {"plain": (False, False), "faults": (True, False), "adaptive": (False, True), "both": (True, True)}
# (strategy, optimizer, dtype, mode, kind): kind "leaf" (packed=False), "legacy", "leafy_opt"
M2 = [(s, "sgd", "float32", "plain", "leaf") for s in STRATS]
M2 += [(s, o, d, "plain", "leaf") for s in WIDE for o, d in (("adamw", "float32"), ("sgd", "bfloat16"),
                                                               ("adamw", "bfloat16"))]
M2 += [("overlap", "sgd", "float32", mode, "leaf") for mode in ("faults", "adaptive")]
M2 += [(s, "sgd", "float32", "both", "leaf") for s in ("overlap", "gossip_ring", "sparse_anchor", "delayed_avg",
                                                       "local_sgd", "easgd")]
M2 += [(s, "sgd", "float32", "plain", "legacy") for s in LEGACY] + [("overlap", "sgd", "float32", "adaptive", "legacy")]
M2 += [(s, o, "float32", "plain", "leafy_opt") for s, o in LEAFY]
PACKED = [s for s in STRATS]  # the packed rank path of the plain SGD f32 cases
M4 = [("overlap", "sgd", "float32", "faults", "leaf"), ("cocod", "sgd", "float32", "plain", "leaf"),
      ("sparse_anchor", "sgd", "float32", "plain", "leaf"), ("gossip_ring", "sgd", "float32", "plain", "leaf"),
      ("gossip_exp", "sgd", "float32", "plain", "leaf"), ("powersgd", "sgd", "float32", "plain", "leaf"),
      ("overlap", "sgd", "float32", "plain", "legacy")]
CKPT = [("overlap", "sgd", "float32", "leaf"), ("overlap", "sgd", "bfloat16", "leaf"),
        ("overlap", "adamw", "float32", "leaf"), ("cocod", "sgd", "float32", "leaf"),
        ("sparse_anchor", "sgd", "float32", "leaf"), ("gossip_ring", "sgd", "float32", "leaf"),
        ("powersgd", "sgd", "float32", "leaf"), ("cocod", "sgd", "float32", "legacy"),
        ("overlap", "sgd", "float32", "leafy_opt")]
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


def _case(strat, opt, dtype, mode, kind, m, **kw):
    faults, adaptive = MODES[mode]
    return dict(dict(path=True, strategy=dict(STRATS[strat], tau=2, packed=kind == "packed" or kind == "leafy_opt"),
                     optimizer=opt, dtype=dtype, m=m, params=_params(), rounds=3, plan=PLANS[m] if faults else None,
                     ctrl=CTRL if adaptive else None, legacy=kind == "legacy", leafy_opt=kind == "leafy_opt"), **kw)


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """The one-process files the ranks restore, then every case on two gloo
    ranks in one spawn. Returns (named cases, per-rank results by name, the
    directory)."""
    where = tmp_path_factory.mktemp("dist_perleaf")
    cases = {}
    for c in M2:
        cases["m2-" + "-".join(c)] = _case(*c, 2)
    for s in PACKED:
        cases[f"packed-{s}"] = _case(s, "sgd", "float32", "plain", "packed", 2)
    for c in M4:
        cases["m4-" + "-".join(c)] = _case(*c, 4)
    for strat, opt, dtype, kind in CKPT:
        cases[f"save-{strat}-{opt}-{dtype}-{kind}"] = _case(strat, opt, dtype, "plain", kind, 2, save=True, more=1,
                                                            dir=str(where))
    for strat in ELASTIC:  # the one-process m 2 file onto m 4
        cases[f"elastic-{strat}"] = _case(strat, "sgd", "float32", "plain", "leaf", 4, rounds=0, elastic=True, more=1,
                                          dir=str(where),
                                          restore=str(where / f"save-save-{strat}-sgd-float32-leaf-one.npz"))
    for name, case in cases.items():
        case["name"] = name
    for strat in ELASTIC:  # the files the elastic cases read
        ranks.run_path_case(cases[f"save-{strat}-sgd-float32-leaf"])
    per_rank = ranks.spawn(where, list(cases.values()), 2)
    return cases, {name: [res[i] for res in per_rank] for i, name in enumerate(cases)}, where


def _equal(a: dict, b: dict, what):
    assert sorted(a) == sorted(b), what
    for key in a:
        assert ranks.same_bytes(a[key], b[key]), (what, key)


def _x_leaves(per_rank):
    return [np.concatenate([res["x_leaves"][i] for res in per_rank]) for i in range(len(per_rank[0]["x_leaves"]))]


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


# -- two ranks of one row: the one-process per-leaf port and the packed rank path, bit for bit --


@pytest.mark.parametrize("case_id", ["-".join(c) for c in M2])
def test_two_ranks_perleaf_fit_is_the_one_process_fit_bit_for_bit(spawned, case_id):
    cases, results, _ = spawned
    case, per_rank = cases["m2-" + case_id], results["m2-" + case_id]
    _readers_equal_on_ranks(per_rank)
    got = per_rank[0]
    assert all(res["drain_idempotent"] for res in per_rank)
    assert any(k.startswith("x::") for k in got["rows"]) and not any(k.startswith("x::") and k[3:].isdigit()
                                                                  for k in got["state"])  # x per leaf
    one = ranks.run_path_case(case)
    assert got["loss"] == one["loss"]
    assert got["fault_log"] == one["fault_log"] and got["steps"] == one["steps"]
    assert _schedule(got["tau_schedule"]) == _schedule(one["tau_schedule"])
    if one["tau_schedule"] is not None:
        for name in ("drift", "scale"):
            np.testing.assert_allclose([h[name] for h in got["tau_schedule"]],
                                       [h[name] for h in one["tau_schedule"]], rtol=1e-6)
    _equal(ranks.gathered(per_rank), one["state"], case_id)
    assert all(ranks.same_bytes(a, b) for a, b in zip(got["consensus"], one["consensus"]))
    assert got["evaluate"] == one["evaluate"] and got["anchor_plane"] == one["anchor_plane"]


@pytest.mark.parametrize("case_id", ["-".join(c) for c in M2 if c[3] == "plain" and c[1:3] == ("sgd", "float32")
                                     and (c[4] != "legacy" or c[0] in ("overlap", "overlap_beta0", "sync_sgd"))])
def test_two_ranks_perleaf_fit_is_the_packed_rank_path_bit_for_bit(spawned, case_id):
    """The per-leaf run on the ranks against the packed rank boundary's run
    of the same strategy on the same ranks: losses, x's leaves (gathered),
    the consensus and ``evaluate()``."""
    _, results, _ = spawned
    strat = case_id.split("-sgd-")[0]
    got, packed = results["m2-" + case_id], results[f"packed-{strat}"]
    assert got[0]["loss"] == packed[0]["loss"]
    assert all(ranks.same_bytes(a, b) for a, b in zip(_x_leaves(got), _x_leaves(packed)))
    assert all(ranks.same_bytes(a, b) for a, b in zip(got[0]["consensus"], packed[0]["consensus"]))
    assert got[0]["evaluate"] == packed[0]["evaluate"]


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


# -- checkpoints of per-leaf rank states -----------------------------------------------------------


@pytest.mark.parametrize("strat,opt,dtype,kind", CKPT, ids=["-".join(c) for c in CKPT])
def test_perleaf_rank_checkpoint_round_trips(spawned, strat, opt, dtype, kind):
    """The ranks' file is the one-process per-leaf file byte for byte; it
    restores on the ranks (W 2) and in one process (W 1) bitwise, and one
    more round after it is the one-process round."""
    from repro_torch import checkpoint
    from repro_torch.training import drain

    cases, results, where = spawned
    name = f"save-{strat}-{opt}-{dtype}-{kind}"
    per_rank = results[name]
    one = ranks.run_path_case(cases[name])
    got, want = _npz(where / f"save-{name}-mesh.npz"), _npz(where / f"save-{name}-one.npz")
    _equal(got, want, name)
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
    """A one-process m 2 per-leaf file onto two ranks at m 4
    (``elastic=True``: new rows from row 0) equals the one-process elastic
    restore, and the round after it agrees within the m 4 bound."""
    cases, results, _ = spawned
    name = f"elastic-{strat}"
    one = ranks.run_path_case(cases[name])
    restored = ranks.gathered(results[name], "restored")
    _equal(restored, one["restored"], name)
    x = next(v for k, v in restored.items() if k.startswith("x::"))
    assert x.shape[0] == 4 and np.array_equal(x[2], x[0])
    np.testing.assert_allclose(results[name][0]["loss"], one["loss"], rtol=1e-5)


ROWS = {("overlap", "adamw", "leaf"): ("x::", "opt::"), ("powersgd", "sgd", "leaf"): ("x::", "opt::", "vars::extra::err::"),
        ("cocod", "sgd", "leaf"): ("x::", "opt::", "inflight::x0::"),
        ("cocod", "sgd", "legacy"): ("x::", "opt::", "vars::extra::"),
        ("gossip_ring", "sgd", "leaf"): ("x::", "opt::", "inflight::mix::")}


@pytest.mark.parametrize("strat,opt,kind", list(ROWS), ids=["-".join(c) for c in ROWS])
def test_row_stacked_leaves_are_the_ones_their_types_declare(strat, opt, kind):
    """The leaves the checkpointer gathers as rows on a mesh are exactly
    those under the fields that their NamedTuples name in ``ROWS`` (x, the
    optimizer state with the per-worker Adam count, PowerSGD's error, x₀,
    the gossip mix, legacy CoCoD's round start); z, v, the sparse error,
    q, the average and the gossip weights are not, and neither is an
    undeclared optimizer tensor of one or more dims."""
    from typing import NamedTuple

    from repro_torch.checkpoint import checkpointer as ck
    from repro_torch.training import drain

    exp = ranks._experiment(_case(strat, opt, "float32", "plain", kind, 2))
    exp.fit(rounds=1)
    state = drain(exp.state)
    row_ids = ck._row_leaves(state)
    got = {k for k, n in ck._nodes(state) if id(n) in row_ids}
    want = {k for k, _ in ck._nodes(state) if k.startswith(ROWS[(strat, opt, kind)])}
    assert got == want and any(k.startswith("x::") for k in got), (got ^ want)

    class Scaled(NamedTuple):  # an optimizer state with a replicated (n,) tensor beside its rows
        mu: dict
        scale: torch.Tensor

        ROWS = ("mu",)

    first = next(iter(state.x.values()))
    odd = state._replace(opt=Scaled(mu=state.x, scale=torch.ones(first.shape[0])))
    ids = ck._row_leaves(odd)
    assert id(odd.opt.scale) not in ids and all(id(t) in ids for t in odd.opt.mu.values())


# -- one rank in this process: the legacy shims' refusal, a per-leaf LM's readers --------------


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


def test_legacy_shim_refuses_a_membership_on_ranks(one_rank):
    import warnings

    from repro_torch.config import AlgoConfig, OptimizerConfig
    from repro_torch.core.algorithms import make_algorithm
    from repro_torch.fault import from_mask
    from repro_torch.models import classifier as clf
    from repro_torch.optim import from_config, schedules
    from repro_torch.parallel.sharding import mesh_context
    from repro_torch.training import make_round_step, make_train_state

    params = clf.init_mlp(torch.Generator().manual_seed(0), 8, 3, hidden=(4,))
    opt = from_config(OptimizerConfig())
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        algo = make_algorithm(AlgoConfig(tau=2))
    batch = (torch.zeros(2, 2, 2, 8), torch.zeros(2, 2, 2, dtype=torch.int32))
    with mesh_context(one_rank):
        state = make_train_state(params, 2, opt, algo)
        step = make_round_step(clf.mlp_loss, opt, algo, schedules.constant(0.1))
        state = step(state, batch)[0]  # fully live: runs
        with pytest.raises(ValueError, match="membership"):
            step(state._replace(membership=from_mask(np.array([1.0, 0.0], np.float32))), batch)


def test_perleaf_lm_readers_on_one_rank(one_rank):
    """The reduced qwen2-7b per leaf on one rank holding both rows: a
    round, then ``consensus()`` bit for bit the one-process per-leaf
    consensus, ``consensus_plane()`` refused as off a mesh, ``serve()``
    builds an engine over the consensus."""
    from repro_torch.api import Experiment, TokenStream
    from repro_torch.config import AlgoConfig
    from repro_torch.parallel.packing import tree_flatten
    from repro_torch.parallel.sharding import mesh_context

    def build():
        return Experiment(arch="qwen2-7b", workers=2, strategy=AlgoConfig(tau=2, packed=False),
                          data=TokenStream(batch_per_worker=1, seq_len=16), device="cpu")

    one = build()
    one.fit(rounds=1)
    with mesh_context(one_rank):
        exp = build()
        exp.fit(rounds=1)
        got = exp.consensus()
        assert all(torch.equal(a, b) for a, b in zip(tree_flatten(got)[0], tree_flatten(one.consensus())[0]))
        with pytest.raises(ValueError, match="consensus_plane"):
            exp.consensus_plane()
        assert exp.serve(slots=1, max_len=32) is not None


# -- the JAX reference ---------------------------------------------------------------------------


def test_two_ranks_perleaf_fit_matches_jax(spawned):
    _, results, _ = spawned
    got = results["m2-overlap-sgd-float32-plain-leaf"][0]
    j = JExperiment(task=JSpec(**SMALL), workers=2, strategy=JAlgo(anchor_beta=0.7, tau=2, packed=False)).build()
    jres = j.fit(rounds=3)
    np.testing.assert_allclose(got["loss"], [float(v) for v in jres.losses], rtol=1e-4)
    assert np.isfinite(got["loss"]).all()
