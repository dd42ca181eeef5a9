"""Fault-tolerant boundaries in the port (repro_torch) against the JAX
reference, on the CPU: the fault plan, the membership, every strategy's
masked boundary (with the consensus probe), the anchor re-sync, and whole
``fit(faults=...)`` runs, alone and with adaptive τ.

Both packages get the same inputs: the same plan specs, and the reference's
state (built, or after one of its rounds, where the workers differ) carried
over bit for bit by ``repro_torch.interop``. Stated tolerances and why:

* plans and memberships: exact (the plan is a numpy copy on the same
  ``(seed, round)`` substreams; the weights are one f32 division);
* masked boundaries (three in a row: one dead worker, two dead, then fully
  live, which consumes a push launched while two were dead), f32: every
  slot within 4 ulps of its largest magnitude, as
  ``tests/test_torch_strategies.py::test_boundaries_match_jax`` (weighted
  worker sums and the gossip push sum in other orders than XLA's), and the
  anchor momentum v = β·v + (mean − z) within 4 ulps of the anchor's
  magnitude (mean − z cancels: it keeps the ulp of its operands, as the
  sparse anchor's error plane there); the probe's scale rtol 1e-6 and its
  drift rtol 1e-6 plus one f32 ulp of the scale — at consensus (after
  local_sgd's or sync_sgd's average) the drift is only the rounding of the
  two packages' worker means, which sum in other orders;
* the re-sync: bit for bit where it copies an anchor plane (overlap), within
  4 ulps where it sums one (local_sgd's live mean, gossip's Σ mix / Σ w);
* fits: the fault log, τ schedule and decisions exactly; losses rtol 1e-4,
  drift and scale rtol 1e-5 (as ``tests/test_torch_control.py``).
"""
import numpy as np
import pytest
import jax
import torch

from repro.api import ClassificationSpec as JSpec
from repro.api import Experiment as JExperiment
from repro.config import AlgoConfig as JAlgo
from repro.control import TauController as JTauController
from repro.data import loaders as jloaders
from repro.fault import FaultPlan as JFaultPlan
from repro.fault import from_mask as jfrom_mask
from repro.fault import full as jfull
from repro.fault import resync_from_anchor as jresync_from_anchor
from repro_torch import interop
from repro_torch.api import ClassificationSpec, Experiment
from repro_torch.config import AlgoConfig
from repro_torch.control import TauController
from repro_torch.fault import FaultHarness, FaultPlan, Membership, from_mask, full, resync_from_anchor
from repro_torch.parallel import packing

SMALL = dict(n=2000, holdout=500)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small CPU ops: torch's thread pool only contends with XLA's here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _slots(v, name="", out=None):
    """Every array of a (JAX or port) state or slot, as numpy by name."""
    out = {} if out is None else out
    if v is None:
        return out
    if hasattr(v, "buffers") and hasattr(v, "layout"):
        for i, b in enumerate(v.buffers):
            _slots(b, f"{name}{i}", out)
    elif hasattr(v, "_fields"):
        for f in v._fields:
            _slots(getattr(v, f), f"{name}.{f}", out)
    elif isinstance(v, dict):
        _slots(tuple(packing.tree_flatten(v)[0]), name, out)
    elif isinstance(v, (tuple, list)):
        for i, a in enumerate(v):
            _slots(a, f"{name}[{i}]", out)
    elif isinstance(v, torch.Tensor):
        out[name] = (v.float() if v.is_floating_point() else v).numpy()
    else:
        a = np.asarray(v)
        out[name] = a.astype(np.float32) if a.dtype.kind == "f" or a.dtype.name == "bfloat16" else a
    return out


def _within_ulps(want, got, n, scale=None):
    """Every float slot within ``n`` f32 ulps of its largest magnitude (or of
    ``scale[name]``'s); other slots exactly."""
    assert sorted(want) == sorted(got)
    for k in want:
        if want[k].dtype.kind != "f":
            assert np.array_equal(got[k], want[k]), k
            continue
        ref = (scale or {}).get(k, want[k])
        lim = n * np.spacing(np.float32(np.abs(ref).max())) if want[k].size else 0.0
        err = np.abs(got[k].astype(np.float64) - want[k]).max() if want[k].size else 0.0
        assert err <= lim, (k, err, lim)


# -- the plan -------------------------------------------------------------------------

PLAN_SPECS = [
    ("crash:1@2-5,slow:2x4", 4, 7),
    ("std:0.4,prob:0.1@5,jitter:0.2", 8, 3),
    ("crash:0@3,crash:2@1-4,deadline:2.5,std:0.6", 5, 1),
    ("crash:0@0-2,crash:1@0-3,crash:2@1,crash:3@2-6", 4, 0),  # round 2: every worker crashed
    ("prob:0.5@6,deadline:2,slow:5x1.5", 6, 11),
]


@pytest.mark.parametrize("spec,m,seed", PLAN_SPECS)
def test_plan_matches_jax_over_20_rounds(spec, m, seed):
    j, p = JFaultPlan.parse(spec, m=m, seed=seed), FaultPlan.parse(spec, m=m, seed=seed)
    assert p.events() == j.events()
    for r in range(20):
        for fn in ("mask_at", "resync_at", "crashed_at", "deadline_missed", "round_compute_factors"):
            assert np.array_equal(getattr(p, fn)(r), getattr(j, fn)(r)), (fn, r)
        assert p.fault_reason(r) == j.fault_reason(r) and p.comm_jitter(r) == j.comm_jitter(r)
    assert p.degraded_rounds(20) == j.degraded_rounds(20)


def test_plan_rejects_what_jax_rejects():
    for bad in (dict(m=4, crashes=((7, 1, None),)), dict(m=4, crashes=((1, 5, 3),)), dict(m=4, slowdown=((0, -1.0),))):
        with pytest.raises(ValueError):
            JFaultPlan(**bad)
        with pytest.raises(ValueError):
            FaultPlan(**bad)
    with pytest.raises(ValueError, match="unknown fault spec"):
        FaultPlan.parse("explode:1@2", m=4)
    assert FaultPlan.parse("crash:0@3", m=2).crashes == JFaultPlan.parse("crash:0@3", m=2).crashes == ((0, 3, None),)


# -- the membership ---------------------------------------------------------------------


def test_membership_matches_jax():
    for m in (1, 3, 5, 16):
        assert np.array_equal(full(m).weights.numpy(), np.asarray(jfull(m).weights))
        assert full(m).is_full() and full(m).m == m
    for mask in ([1, 0, 1, 1, 1], [0, 0, 1, 0, 1], [1, 1, 1]):
        want, got = jfrom_mask(np.asarray(mask, np.float32)), from_mask(np.asarray(mask, np.float32))
        assert isinstance(got, Membership) and got.weights.dtype == torch.float32
        assert np.array_equal(got.mask.numpy(), np.asarray(want.mask))
        assert np.array_equal(got.weights.numpy(), np.asarray(want.weights))
        assert float(got.live_count()) == float(want.live_count()) and got.is_full() == want.is_full()
    with pytest.raises(ValueError, match="no live workers"):
        from_mask(np.zeros(3, np.float32))
    with pytest.raises(ValueError, match="1-D"):
        from_mask(np.ones((2, 2), np.float32))


# -- masked boundaries ------------------------------------------------------------------

M = 5
MASKS = ([1, 1, 0, 1, 1], [1, 0, 0, 1, 1], None)

BOUNDARY_CASES = [
    dict(name="overlap_local_sgd"),
    dict(name="overlap_local_sgd", anchor_beta=0.0),
    dict(name="local_sgd"),
    dict(name="sync_sgd"),
    dict(name="powersgd"),
    dict(name="easgd"),
    dict(name="cocod"),
    dict(name="delayed_avg", delay_steps=1),
    dict(name="delayed_avg", delay_steps=2),
    dict(name="sparse_anchor", sparse_k=1.0),
    dict(name="gossip_full"),
    dict(name="gossip_ring"),
    dict(name="gossip_exp"),
    dict(name="sgp", topology="ring"),
]


def _mid_training(strategy):
    """Both packages' experiments and the state after one reference round
    (the workers differ, a collective is in flight), the port's a copy."""
    j = JExperiment(task=JSpec(**SMALL), strategy=JAlgo(**strategy), workers=M).build()
    p = Experiment(task=ClassificationSpec(**SMALL), strategy=AlgoConfig(**strategy), workers=M, device="cpu").build()
    jstate, _ = j.step_fn(j.state, jloaders.round_batch(j.next_batch, j.tau))
    return j, p, jstate, interop.state_from_numpy(_np(jstate), packing.layout_of(p.params))


@pytest.mark.parametrize("strategy", BOUNDARY_CASES, ids=lambda s: "-".join(str(v) for v in s.values()))
def test_masked_probed_boundaries_match_jax(strategy):
    """Three boundaries with ``probe=True``: one worker dead, two dead, then
    fully live; the dead rows pass through (checked exactly), the rest
    within 4 ulps of the reference, the stats within rtol 1e-6."""
    j, p, jstate, pstate = _mid_training(strategy)
    jx, jv, ji = jstate.x, jstate.vars, jstate.inflight
    px, pv, pi = pstate.x, pstate.vars, pstate.inflight
    for mask in MASKS:
        jm = None if mask is None else jfrom_mask(np.asarray(mask, np.float32))
        pm = None if mask is None else from_mask(np.asarray(mask, np.float32))
        before = [b.clone() for b in px.buffers]
        jx, jv, ji, jst = j.strategy_obj.boundary_round(jx, jv, ji, probe=True, membership=jm)
        px, pv, pi, pst = p.strategy_obj.boundary_round(px, pv, pi, probe=True, membership=pm)
        assert px is pstate.x  # in place
        np.testing.assert_allclose(float(pst.scale), float(jst.scale), rtol=1e-6)
        assert abs(float(pst.drift) - float(jst.drift)) <= 1e-6 * float(jst.drift) + np.spacing(np.float32(jst.scale))
        if mask is not None and strategy["name"] not in ("sync_sgd", "powersgd"):
            dead = [i for i, live in enumerate(mask) if not live]
            assert all(torch.equal(b[dead], a[dead]) for a, b in zip(before, px.buffers))
        want, got = _slots((jx, jv, ji)), _slots((px, pv, pi))
        scale = {k: want["[1].z0"] for k in want if k.startswith("[1].v")}
        for k in scale:
            err = np.abs(got[k].astype(np.float64) - want[k]).max()
            print(f"{k}: {err / np.spacing(np.float32(np.abs(want[k]).max())):.0f} ulps of its own magnitude, "
                  f"{err / np.spacing(np.float32(np.abs(scale[k]).max())):.0f} of the anchor's")
        _within_ulps(want, got, 4, scale)


def test_probe_of_the_fused_boundary_is_the_pre_boundary_plane():
    """The overlap boundary's stats (K3's probe output) equal the standalone
    probe of a copy of the plane taken before it, masked or not."""
    from repro_torch.kernels.consensus_probe import packed_probe

    _, p, _, pstate = _mid_training(dict(name="overlap_local_sgd"))
    for mask in MASKS:
        copy = packing.Packed(tuple(b.clone() for b in pstate.x.buffers), pstate.x.layout)
        mem = None if mask is None else from_mask(np.asarray(mask, np.float32))
        *_, stats = p.strategy_obj.boundary_round(pstate.x, pstate.vars, pstate.inflight, probe=True, membership=mem)
        want = packed_probe(copy)
        assert torch.equal(stats.drift, want.drift) and torch.equal(stats.scale, want.scale)


# -- the re-sync ------------------------------------------------------------------------


@pytest.mark.parametrize("name,ulps", [("overlap_local_sgd", 0), ("local_sgd", 4), ("gossip_ring", 4)])
def test_resync_from_anchor_matches_jax(name, ulps):
    """Workers 1 and 4 re-synced from the anchor of a mid-training state (the
    launched anchor; local_sgd's live mean of workers 0, 2, 3; gossip's
    debiased push sum), in place; the other rows untouched."""
    _, _, jstate, pstate = _mid_training(dict(name=name))
    mask = np.array([False, True, False, False, True])
    want = _np(jresync_from_anchor(jstate, mask).x)
    before = [b.clone() for b in pstate.x.buffers]
    out = resync_from_anchor(pstate, mask)
    assert out.x is pstate.x
    for i, (a, b) in enumerate(zip(before, out.x.buffers)):
        assert torch.equal(b[[0, 2, 3]], a[[0, 2, 3]])
        assert torch.equal(b[1], b[4])
        lim = ulps * np.spacing(np.float32(np.abs(want.buffers[i]).max()))
        assert np.abs(b.numpy().astype(np.float64) - want.buffers[i]).max() <= lim


# -- whole fits ---------------------------------------------------------------------------


def _pair(strategy, workers=4):
    """The reference's fault-test configuration (the default 30,000-sample
    task) in both packages, the port from the reference's built state."""
    j = JExperiment(workers=workers, strategy=strategy, seed=0).build()
    p = Experiment(workers=workers, strategy=strategy, seed=0, device="cpu").build()
    p.state = interop.state_from_numpy(_np(j.state), packing.layout_of(p.params))
    return j, p


@pytest.mark.parametrize("strategy", ["overlap_local_sgd", "easgd", "local_sgd", "cocod", "gossip_ring"])
def test_faulted_fit_matches_jax(strategy):
    """The reference's acceptance run: worker 1 crashed for rounds 2-4,
    worker 2 a 4x straggler past the deadline every round; 8 rounds."""
    j, p = _pair(strategy)
    jres = j.fit(rounds=8, faults=JFaultPlan.parse("crash:1@2-5,slow:2x4", m=4, seed=7))
    pres = p.fit(rounds=8, faults=FaultPlan.parse("crash:1@2-5,slow:2x4", m=4, seed=7))
    assert pres.fault_log == jres.fault_log
    by_round = {rec["round"]: rec for rec in pres.fault_log}
    assert by_round[3]["excluded"] == [1, 2] and by_round[5]["resynced"] == [1]
    np.testing.assert_allclose(pres.losses, jres.losses, rtol=1e-4)
    assert np.isfinite(pres.losses).all() and pres.losses[-1] < pres.losses[0]
    assert p.state.membership is None and pres.state.membership is None and pres.tau_schedule is None
    assert pres.steps == jres.steps == 16


@pytest.mark.parametrize("strategy", ["overlap_local_sgd", "gossip_ring"])
def test_faulted_fit_composes_with_adaptive_tau_like_jax(strategy):
    """Worker 1 crashed for rounds 1-2 under a controller: rounds 1-3 are
    ``fault_hold`` (round 3's reason "rejoin"), the schedule as the
    reference's."""
    j, p = _pair(strategy)
    fields = dict(tau=2, tau_min=1, tau_max=8)
    jres = j.fit(rounds=4, faults=JFaultPlan.parse("crash:1@1-3", m=4, seed=0), adaptive_tau=JTauController(**fields))
    pres = p.fit(rounds=4, faults=FaultPlan.parse("crash:1@1-3", m=4, seed=0), adaptive_tau=TauController(**fields))
    assert pres.fault_log == jres.fault_log
    keys = ("round", "tau", "decision", "next_tau")
    assert [{k: h[k] for k in keys} for h in pres.tau_schedule] == [{k: h[k] for k in keys} for h in jres.tau_schedule]
    assert [h.get("fault") for h in pres.tau_schedule] == [None, "crash", "crash", "rejoin"]
    for name in ("drift", "scale"):
        np.testing.assert_allclose([h[name] for h in pres.tau_schedule], [h[name] for h in jres.tau_schedule],
                                   rtol=1e-5)
    np.testing.assert_allclose(pres.losses, jres.losses, rtol=1e-4)
    assert len(p.tau_programs) == len(j.tau_programs) and p.state.membership is None


def test_faulted_fit_guards():
    exp = Experiment(task=ClassificationSpec(**SMALL), workers=4, device="cpu")
    with pytest.raises(TypeError, match="FaultPlan"):
        exp.fit(rounds=1, faults=object())
    with pytest.raises(ValueError, match="m=5"):
        exp.fit(rounds=1, faults=FaultPlan(m=5))


def test_harness_installs_and_clears_the_membership():
    exp = Experiment(task=ClassificationSpec(**SMALL), workers=4, device="cpu").build()
    harness = FaultHarness(FaultPlan.parse("crash:1@1-2", m=4))
    state = harness.before_round(exp.state, 0)
    assert state.membership is None and harness.records == []
    state = harness.before_round(state, 1)
    assert np.array_equal(state.membership.mask.numpy(), [1, 0, 1, 1]) and harness.fault_reason(1) == "crash"
    state = harness.before_round(state, 2)
    assert state.membership is None
    assert harness.records == [dict(round=1, live=3, excluded=[1], resynced=[], reason="crash"),
                               dict(round=2, live=4, excluded=[], resynced=[1], reason="rejoin")]
