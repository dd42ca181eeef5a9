"""Adaptive τ in the port (repro_torch) against the JAX reference, on the
CPU: the consensus probe (K8's plain version and the probe output of the
K3/K4 plain versions), the controller, the per-τ program cache, and whole
``fit(adaptive_tau=...)`` runs of the classifier and one LM round.

Both packages get the same inputs: numpy data from one seed and, where
weights matter, the reference's ``Experiment.build()`` state carried over
bit for bit by ``repro_torch.interop``. Stated tolerances and why:

* the probe's two raw sums: rtol 1e-6 against ``ref.plane_probe`` and the
  Pallas kernel in interpret mode (the sums run in other orders); the
  other outputs of K3/K4 as ``tests/test_torch_kernels.py`` holds them, and
  bit for bit the same with and without the probe;
* the controller: its records exactly (it is a copy, on the same floats);
* fits: the τ schedules, decisions and program counts exactly; drift and
  scale rtol 1e-5 and losses rtol 1e-4 (the bound of the 20-round fits in
  ``tests/test_torch_training.py``). A decision is discontinuous in the
  drift ratio, so each configuration's ratios are checked to sit at least
  1e-3 (relative) away from the band edges ``lo`` and ``hi``; the margins
  are printed.
"""
import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import ClassificationSpec as JSpec
from repro.api import Experiment as JExperiment
from repro.api import TokenStream as JTokenStream
from repro.config import AlgoConfig as JAlgo
from repro.config import OptimizerConfig as JOpt
from repro.config import get_arch as jax_get_arch
from repro.control import AdaptiveTau as JAdaptiveTau
from repro.control import RoundProgramCache as JRoundProgramCache
from repro.control import TauController as JTauController
from repro.control import consensus_drift as jconsensus_drift
from repro.data import loaders as jloaders
from repro.kernels import flags as jflags
from repro.kernels.anchor_mix import ops as jam_ops
from repro.kernels.consensus_probe import ops as jprobe_ops
from repro.kernels.consensus_probe import ref as jprobe_ref
from repro.optim import schedules as jsched
from repro.parallel.packing import unpack as jax_unpack
from repro_torch import interop
from repro_torch.api import ClassificationSpec, Experiment, TokenStream
from repro_torch.config import AlgoConfig, OptimizerConfig, get_arch
from repro_torch.control import AdaptiveTau, RoundProgramCache, TauController, TauScheduledTrainer, consensus_drift
from repro_torch.kernels.anchor_mix import ops as am_ops
from repro_torch.kernels.consensus_probe import ConsensusStats, packed_probe, probe_buffer, stats_from_partials
from repro_torch.kernels.consensus_probe import tree_probe
from repro_torch.optim import schedules
from repro_torch.parallel import packing


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small CPU ops: torch's thread pool only contends with XLA's here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


# -- K8: the standalone probe ---------------------------------------------------------


@pytest.mark.parametrize("n", [128, 384, 1024, 1000])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("against", ["ref", "pallas_interpret"])
def test_probe_plain_matches_jax(against, dtype, n, rng):
    """``probe_buffer`` (the plain version on the CPU) against the reference's
    ``plane_probe`` and its Pallas kernel in interpret mode (which pads
    n = 1000 to 1024 lanes of zeros): both raw sums within rtol 1e-6."""
    x = (rng.normal(size=(4, n)) + 0.5 * rng.normal(size=(1, n))).astype(np.float32)
    jxa = jnp.asarray(x, dtype)
    if against == "ref":
        want = jprobe_ref.plane_probe(jxa)
    else:
        with jflags.force_pallas():
            want = jprobe_ops.probe_buffer(jxa)
    got = probe_buffer(_t(x, getattr(torch, dtype)))
    assert got.shape == (2,) and got.dtype == torch.float32
    want = np.array([float(want[0]), float(want[1])])
    print(f"probe max rel err {np.max(np.abs(got.numpy() - want) / np.abs(want)):.3g}")
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


def test_probe_reads_any_width_and_rejects_bad_input():
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    # worker mean [1.5, 2.5, 3.5]; every deviation is ±1.5
    assert torch.equal(probe_buffer(x), torch.tensor([6 * 2.25, 2.25 + 6.25 + 12.25]))
    assert torch.equal(probe_buffer(torch.zeros(3, 0)), torch.zeros(2))
    with pytest.raises(ValueError, match=r"\(m, n\)"):
        probe_buffer(torch.zeros(4))


def test_stats_and_probes_match_jax():
    """``packed_probe`` over a plane of differing workers (the state after
    one reference round), ``tree_probe`` over its leaves and the per-leaf
    oracle ``consensus_drift``: within rtol 1e-6 of the reference's."""
    j = JExperiment(task=JSpec(n=2000, holdout=500), workers=5).build()
    jstate, _ = j.step_fn(j.state, jloaders.round_batch(j.next_batch, j.tau))
    p = Experiment(task=ClassificationSpec(n=2000, holdout=500), workers=5, device="cpu").build()
    px = interop.state_from_numpy(_np(jstate), packing.layout_of(p.params)).x
    want = jprobe_ops.packed_probe(jstate.x)
    got = packed_probe(px)
    assert isinstance(got, ConsensusStats) and got.drift.dim() == 0 and got.drift.dtype == torch.float32
    np.testing.assert_allclose([float(got.drift), float(got.scale)], [float(want.drift), float(want.scale)], rtol=1e-6)
    jtree = jax.tree.map(np.asarray, jax_unpack(jstate.x))
    want = jprobe_ops.tree_probe(jtree)
    got = tree_probe(packing.unpack(px))
    np.testing.assert_allclose([float(got.drift), float(got.scale)], [float(want.drift), float(want.scale)], rtol=1e-6)
    want = jconsensus_drift(jstate.x)
    got = consensus_drift(px)
    np.testing.assert_allclose([float(v) for v in got], [float(v) for v in want], rtol=1e-6)
    got = stats_from_partials([torch.tensor([8.0, 9.0]), torch.tensor([10.0, 16.0])], 2)
    assert float(got.drift) == 3.0 and float(got.scale) == 5.0


# -- the probe output of K3/K4 ----------------------------------------------------------


def _close(got, want, dtype, scale=None):
    """As ``tests/test_torch_kernels.py``: f32 within 2 ulps (plus the
    operands' ulps against interpret mode, which contracts ``a*b + c``),
    bf16 within one bf16 ulp."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)

    def bf16_ulp(a):
        _, e = np.frexp(np.abs(a).astype(np.float32))
        return np.ldexp(np.float32(1), e - 8)

    ulp = (lambda a: 2 * np.spacing(np.abs(a))) if dtype == "float32" else bf16_ulp
    lim = ulp(want) + (0 if scale is None else ulp(scale))
    assert (np.abs(got - want) <= lim).all(), np.abs(got - want).max()


def _scale(against, *arrays, like):
    """Elementwise largest operand magnitude (interpret mode only), reduced
    over the worker axis for a per-column output ``like``."""
    if against == "ref":
        return None
    sc = functools.reduce(np.maximum, [np.abs(a) for a in arrays])
    return sc.max(axis=0) if like.dim() == 1 else sc


@pytest.mark.parametrize("m", [1, 4, 16])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("against", ["ref", "pallas_interpret"])
def test_fused_probe_plain_matches_jax(against, dtype, m, rng):
    """K3 and K4 (``mean_pre`` or not) with ``probe=True``, unmasked and with
    one dead row: the stats are those of the pre-pullback plane over all m
    rows (equal to ``probe_buffer`` of a copy of x taken before, bit for
    bit, and within rtol 1e-6 of the reference's), and every other output
    is the same with and without the probe."""
    n, alpha, beta = 384, 0.6, 0.7
    tdt = getattr(torch, dtype)
    x = rng.normal(size=(m, n)).astype(np.float32)
    z = rng.normal(size=(n,)).astype(np.float32)
    v = 0.1 * rng.normal(size=(n,)).astype(np.float32)
    masks = [None]
    if m > 1:
        w = np.full(m, 1.0 / (m - 1), np.float32)
        w[m // 2] = 0.0
        masks.append(w)
    jx_ = lambda a: jnp.asarray(a, dtype)  # noqa: E731

    def jax_call(fn, *args, **kw):
        if against == "ref":
            return getattr(jam_ops, fn)(*args, probe=True, **kw)  # the jnp path: ref.py + plane_probe
        with jflags.force_pallas():
            return getattr(jam_ops, fn)(*args, probe=True, **kw)

    for w in masks:
        jw, tw = (None, None) if w is None else (jnp.asarray(w), _t(w))
        want = jax_call("pullback_mean_momentum", jx_(x), jx_(z), jx_(v), alpha, beta, weights=jw)
        tx, tv = _t(x, tdt), _t(v, tdt)
        before = probe_buffer(tx.clone())
        got = am_ops.pullback_mean_momentum(tx, _t(z, tdt), tv, alpha, beta, probe=True, weights=tw)
        plain = am_ops.pullback_mean_momentum(_t(x, tdt), _t(z, tdt), _t(v, tdt), alpha, beta, weights=tw)
        assert len(got) == 4 and got[0] is tx and got[2] is tv
        assert all(torch.equal(a, b) for a, b in zip(got[:3], plain))
        assert torch.equal(got[3], before)
        for a, b in zip(got[:3], want[:3]):
            _close(a.float().numpy(), np.asarray(b.astype(jnp.float32)), dtype,
                   _scale(against, x, z[None], v[None], like=a))
        np.testing.assert_allclose(got[3].numpy(), [float(want[3][0]), float(want[3][1])], rtol=1e-6)
        for mean_pre in (False, True):
            want = jax_call("pullback_mean", jx_(x), jx_(z), alpha, mean_pre=mean_pre, weights=jw)
            got = am_ops.pullback_mean(_t(x, tdt), _t(z, tdt), alpha, mean_pre=mean_pre, probe=True, weights=tw)
            plain = am_ops.pullback_mean(_t(x, tdt), _t(z, tdt), alpha, mean_pre=mean_pre, weights=tw)
            assert len(got) == 3 and all(torch.equal(a, b) for a, b in zip(got[:2], plain))
            assert torch.equal(got[2], before)
            for a, b in zip(got[:2], want[:2]):
                _close(a.float().numpy(), np.asarray(b.astype(jnp.float32)), dtype, _scale(against, x, z[None], like=a))
            np.testing.assert_allclose(got[2].numpy(), [float(want[2][0]), float(want[2][1])], rtol=1e-6)


# -- the controller ------------------------------------------------------------------------

# (controller fields, [(drift, scale, fault)]): the decision sequences of the
# reference's controller tests, and fault holds inside a cooldown
CONTROLLER_CASES = {
    "grow_shrink_hold": (dict(tau=4, tau_min=1, tau_max=32, lo=0.01, hi=0.05),
                         [(0.005, 1.0, None), (0.03, 1.0, None), (0.2, 1.0, None)]),
    "band_edges": (dict(tau=4, lo=0.01, hi=0.05),
                   [(0.01, 1.0, None), (0.05, 1.0, None), (0.011, 1.0, None), (0.049, 1.0, None), (0.03, 1.0, None)]),
    "warmup": (dict(tau=2, lo=0.01, hi=0.05, warmup_rounds=3), [(0.001, 1.0, None)] * 4),
    "cooldown": (dict(tau=2, lo=0.01, hi=0.05, cooldown_rounds=2), [(0.001, 1.0, None)] * 4),
    "clamp_max": (dict(tau=32, tau_min=1, tau_max=32, lo=0.01, hi=0.05), [(0.001, 1.0, None)]),
    "clamp_min": (dict(tau=1, tau_min=1, tau_max=32, lo=0.01, hi=0.05), [(0.9, 1.0, None)]),
    "zero_scale": (dict(tau=4, lo=0.01, hi=0.05), [(1.0, 0.0, None)]),
    "fault_hold": (dict(tau=2, lo=0.01, hi=0.05, cooldown_rounds=1),
                   [(0.001, 1.0, None), (0.9, 1.0, "crash"), (0.001, 1.0, None), (0.001, 1.0, "crash+rejoin"),
                    (0.001, 1.0, None)]),
}


@pytest.mark.parametrize("case", sorted(CONTROLLER_CASES))
def test_controller_matches_jax(case):
    fields, seq = CONTROLLER_CASES[case]
    j, p = JTauController(**fields), TauController(**fields)
    for drift, scale, fault in seq:
        assert p.update(drift, scale, fault=fault) == j.update(drift, scale, fault=fault)
    assert p.history == j.history and p.taus_seen == j.taus_seen and p.tau == j.tau


def test_controller_defaults_and_fresh_histories():
    assert dataclasses.asdict(TauController()) == dataclasses.asdict(JTauController())
    assert dataclasses.asdict(AdaptiveTau()) == dataclasses.asdict(JAdaptiveTau())
    a, b = TauController(), TauController()
    a.update(0.001, 1.0)
    assert a.history is not b.history and b.history == []


def test_program_cache_counts_builds_like_jax():
    taus = [1, 2, 2, 4, 8, 4, 1, 8]
    built = []
    j, p = JRoundProgramCache(lambda t: ("prog", t)), RoundProgramCache(lambda t: built.append(t) or ("prog", t))
    for t in taus:
        assert p.program_for(t) == j.program_for(t)
    assert (len(p), p.taus, p.compilations) == (len(j), j.taus, j.compilations) == (4, [1, 2, 4, 8], 4)
    assert built == [1, 2, 4, 8] and 4 in p and 3 not in p


def test_tau_scheduled_trainer_drives_the_round_step():
    exp = Experiment(task=ClassificationSpec(n=2000, holdout=500), workers=4, device="cpu").build()
    ctrl = TauController(tau=1, tau_min=1, tau_max=4, lo=0.5, hi=0.9)
    trainer = TauScheduledTrainer(lambda tau: exp.step_fn, ctrl)
    state = exp.state
    for _ in range(3):
        state, metrics, tau = trainer.run_round(state, lambda t: exp.to_device(jloaders.round_batch(exp.next_batch, t)))
        assert metrics["loss"].shape == (tau, 4)
    assert [h["tau"] for h in ctrl.history] == [1, 2, 4] and len(trainer.programs) == 3
    assert trainer.make_step(1) is exp.step_fn and trainer.step_for(2) is exp.step_fn


# -- whole fits against the reference ---------------------------------------------------------


def _pair(noniid, strategy="overlap_local_sgd", workers=4):
    """The reference's adaptive-τ test configuration (the 30,000-sample task)
    in both packages, the port from the reference's built state."""
    j = JExperiment(task=JSpec(noniid=noniid, seed=0), strategy=strategy, workers=workers, seed=0).build()
    p = Experiment(task=ClassificationSpec(noniid=noniid, seed=0), strategy=strategy, workers=workers, seed=0,
                   device="cpu").build()
    p.state = interop.state_from_numpy(_np(j.state), packing.layout_of(p.params))
    return j, p


def _margin(schedule, ctrl_fields):
    """The smallest relative distance of a ratio from the band edges."""
    lo, hi = ctrl_fields.get("lo", 0.01), ctrl_fields.get("hi", 0.05)
    return min(min(abs(h["drift_ratio"] / lo - 1), abs(h["drift_ratio"] / hi - 1)) for h in schedule)


def assert_same_schedule(jres, pres, ctrl_fields, rtol_loss=1e-4):
    js, ps = jres.tau_schedule, pres.tau_schedule
    keys = ("round", "tau", "decision", "next_tau")
    assert [{k: h[k] for k in keys} for h in ps] == [{k: h[k] for k in keys} for h in js]
    assert [h.get("fault") for h in ps] == [h.get("fault") for h in js]
    for name in ("drift", "scale"):
        np.testing.assert_allclose([h[name] for h in ps], [h[name] for h in js], rtol=1e-5, err_msg=name)
    np.testing.assert_allclose(pres.losses, jres.losses, rtol=rtol_loss)
    assert pres.steps == jres.steps == sum(h["tau"] for h in js)
    margin = _margin(js, ctrl_fields)
    print(f"drift ratios {[round(h['drift_ratio'], 5) for h in js]}: nearest band edge {margin:.3g} (relative)")
    assert margin > 1e-3, margin


# (task non-IID?, strategy, controller, rounds): the reference's live fits
# (tests/test_control.py: grow on IID, shrink on non-IID, hold, warmup), and
# the standalone-probe path with local_sgd, cocod and gossip_ring
FIT_CASES = {
    "iid_grows": (False, "overlap_local_sgd", dict(tau=1, tau_min=1, tau_max=8, lo=0.05, hi=0.5), 6),
    "noniid_shrinks": (True, "overlap_local_sgd", dict(tau=8, tau_min=1, tau_max=8, lo=0.01, hi=0.15), 4),
    "iid_holds": (False, "overlap_local_sgd", dict(tau=8, tau_min=1, tau_max=8, lo=0.01, hi=0.15), 1),
    "warmup": (False, "overlap_local_sgd", dict(tau=2, tau_min=1, tau_max=8, lo=0.05, hi=0.5, warmup_rounds=1), 5),
    "local_sgd": (False, "local_sgd", dict(tau=1, tau_min=1, tau_max=8, lo=0.05, hi=0.5), 6),
    "cocod": (False, "cocod", dict(tau=1, tau_min=1, tau_max=8, lo=0.05, hi=0.5), 6),
    "gossip_ring": (False, "gossip_ring", dict(tau=1, tau_min=1, tau_max=8, lo=0.05, hi=0.5), 6),
}


@pytest.mark.parametrize("case", list(FIT_CASES))
def test_fit_adaptive_matches_jax(case):
    noniid, strategy, fields, rounds = FIT_CASES[case]
    j, p = _pair(noniid, strategy)
    jres = j.fit(rounds=rounds, adaptive_tau=JTauController(**fields))
    pres = p.fit(rounds=rounds, adaptive_tau=TauController(**fields))
    assert_same_schedule(jres, pres, fields)
    assert len(p.tau_programs) == len(j.tau_programs) == len({h["tau"] for h in jres.tau_schedule})
    decisions = {h["decision"] for h in pres.tau_schedule}
    if case in ("iid_grows", "local_sgd", "cocod", "gossip_ring"):
        assert "grow" in decisions
    if case == "noniid_shrinks":
        assert "shrink" in decisions
    if case == "iid_holds":
        assert decisions == {"hold"}


def test_fit_adaptive_continues_and_keeps_plain_fit():
    """A later plain fit runs the unprobed step at the strategy's τ; the
    controller's history keeps growing across fits."""
    _, p = _pair(False)
    ctrl = TauController(tau=1, tau_min=1, tau_max=8, lo=0.05, hi=0.5)
    first = p.fit(rounds=2, adaptive_tau=ctrl)
    second = p.fit(rounds=2, adaptive_tau=ctrl)
    assert [h["round"] for h in second.tau_schedule] == [2, 3] and len(ctrl.history) == 4
    plain = p.fit(rounds=2)
    assert plain.tau_schedule is None and plain.steps == 4 and first.fault_log is None


def test_lm_adaptive_round_matches_jax():
    """One adaptive round of the reduced qwen2-7b (f32, m = 2, seq 64), from
    the reference's built state: the loss rtol 1e-5 (as the LM round in
    ``tests/test_torch_lm.py``), drift and scale rtol 1e-5, the decision."""
    cfg_j = jax_get_arch("qwen2-7b").model.reduced()
    cfg_p = get_arch("qwen2-7b").model.reduced()
    kw = dict(workers=2, rounds=1)
    lr = 1e-2
    j = JExperiment(arch=cfg_j, strategy=JAlgo(name="overlap_local_sgd"), optimizer=JOpt(name="sgd", lr=lr),
                    schedule=jsched.constant(lr), data=JTokenStream(2, 64), **kw).build()
    p = Experiment(arch=cfg_p, strategy=AlgoConfig(name="overlap_local_sgd"), optimizer=OptimizerConfig(name="sgd", lr=lr),
                   schedule=schedules.constant(lr), data=TokenStream(2, 64), device="cpu", **kw).build()
    p.state = interop.state_from_numpy(_np(j.state), packing.layout_of(p.params))
    fields = dict(tau=2, tau_min=1, tau_max=4, lo=1e-4, hi=1e-2)
    jres = j.fit(rounds=1, adaptive_tau=JTauController(**fields))
    pres = p.fit(rounds=1, adaptive_tau=TauController(**fields))
    assert pres.tau_schedule[0]["decision"] == jres.tau_schedule[0]["decision"]
    for name in ("drift", "scale"):
        np.testing.assert_allclose(pres.tau_schedule[0][name], jres.tau_schedule[0][name], rtol=1e-5)
    np.testing.assert_allclose(pres.losses, jres.losses, rtol=1e-5)
    assert math.isfinite(pres.tau_schedule[0]["drift_ratio"])
    print(f"LM drift ratio {jres.tau_schedule[0]['drift_ratio']:.5g}: nearest band edge "
          f"{_margin(jres.tau_schedule, fields):.3g} (relative)")
    assert _margin(jres.tau_schedule, fields) > 1e-3
