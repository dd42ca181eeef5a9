"""The port's per-leaf oracle (repro_torch, ``AlgoConfig.packed=False``),
its legacy ``Algorithm`` shims, ``core/mixing`` and ``utils/tree`` against
the JAX reference, and the port's packed path against its own per-leaf
path, on the CPU.

Both packages get the same inputs: numpy data from one seed and the
reference's per-leaf ``Experiment.build()`` state (or the state after one
of its rounds), carried over bit for bit by ``repro_torch.interop``.
Stated tolerances and why:

* port per-leaf vs JAX per-leaf, the bounds ``tests/test_torch_strategies.py``
  and ``tests/test_torch_training.py`` state for the packed path: three f32
  boundaries from a mid-training state, every slot within 4 ulps of its
  largest magnitude (the sparse anchor's error within 4 ulps of the
  anchor's): the worker means sum in other orders (the port: rows
  0 .. m−1; XLA: its own), the gossip push likewise; one round rtol 1e-5,
  atol 1e-6; 20-round fits, losses rtol 1e-4 (sparse anchor at k = 0.5:
  1e-3, a top-k selection is discontinuous at an ulp) and test accuracy
  within 2 / holdout;
* three bf16 boundaries: every slot within one bf16 ulp of its largest
  magnitude (the f32 sums of the two packages may straddle a bf16 rounding
  boundary; observed bitwise), two for the sparse gossip push, whose f32
  sums Peff @ x run in another order before their bf16 rounding and whose
  flips the next boundaries carry on (observed one ulp);
* the port's packed path against its per-leaf path, x, the optimizer state,
  the in-flight value and vars after three rounds (sgd, and adamw with
  clipping), and one masked boundary: **bitwise**, with no exception. Both
  paths run the same ops at the same rounding points (worker means in the
  fixed row order, the plain K1/K2/K3/K4/K5 chains, the gossip push in
  order) on the same values, so nothing depends on XLA's or the host's
  code generation: these are the host-independent counterparts of the
  reference's ``test_packed_boundary_bitwise_matches_perleaf`` (and its
  ``_bf16`` twin) and ``test_packed_local_step_matches_perleaf``;
* each legacy ``Algorithm`` against its native per-leaf strategy: bitwise;
* the overlap path against ``MatrixFormSim`` (eq. 8): rtol 1e-5, atol 1e-5,
  as the reference's own test; ``mixing`` against the reference's: exact;
* ``utils/tree``: the elementwise helpers bitwise in f32 and bf16 (JAX's
  weak scalars rounded to the leaf's dtype), ``tree_dot``/``tree_l2_norm``
  rtol 1e-6 (sums in other orders);
* the per-leaf sgd/adamw step with clipping against ``jax.vmap(opt.step)``:
  sgd bitwise, adamw within 2 f32 ulps (XLA may contract the update) and
  one bf16 ulp; the clipped gradients within 2 ulps (the norm's sums);
* ``pullback_tree`` with a broadcast z against the reference's
  ``_pullback``: bitwise;
* adaptive τ and faulted fits against the reference: as
  ``tests/test_torch_fault.py`` (losses rtol 1e-4, schedules and fault logs
  equal, drift and scale rtol 1e-5);
* per-leaf checkpoints: bitwise both ways.
"""
import dataclasses
import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import ClassificationSpec as JSpec
from repro.api import Experiment as JExperiment
from repro.checkpoint import restore as jrestore
from repro.checkpoint import save as jsave
from repro.config import AlgoConfig as JAlgo
from repro.config import OptimizerConfig as JOpt
from repro.control import TauController as JTauController
from repro.core import mixing as jmixing
from repro.core import strategy as jstrategy
from repro.data import loaders as jloaders
from repro.fault import FaultPlan as JFaultPlan
from repro.models import classifier as jclf
from repro.optim import adamw as jadamw
from repro.optim import clip_by_global_norm as jclip
from repro.optim import sgd as jsgd
from repro.training import make_train_state as jmake_train_state
from repro.utils import tree as jtree
from repro_torch import checkpoint, interop
from repro_torch.api import ClassificationSpec, Experiment
from repro_torch.config import AlgoConfig, OptimizerConfig
from repro_torch.control import TauController
from repro_torch.core import LegacyStrategy, make_strategy, mixing, resolve_strategy
from repro_torch.core import algorithms as palgorithms
from repro_torch.core.strategy import AlgoVars
from repro_torch.fault import FaultPlan, from_mask
from repro_torch.kernels.anchor_mix import ops as am_ops
from repro_torch.optim import adamw, clip_by_global_norm_, packed_capable, schedules, sgd
from repro_torch.optim.optimizers import Optimizer
from repro_torch.parallel import packing
from repro_torch.parallel.packing import Packed, leaf_views, tree_flatten
from repro_torch.training import make_round_step, make_train_state
from repro_torch.utils import tree as ptree

SMALL = dict(n=2000, holdout=500)
M = 4

# the reference's ALL_PACKABLE (tests/test_strategies.py) and every gossip strategy
CASES = [
    ("overlap_local_sgd", dict(anchor_beta=0.0)),
    ("overlap_local_sgd", dict(anchor_beta=0.7)),
    ("local_sgd", {}),
    ("sync_sgd", {}),
    ("easgd", {}),
    ("cocod", {}),
    ("powersgd", {}),
    ("delayed_avg", dict(delay_steps=2)),  # mid-round consume (delay < tau)
    ("delayed_avg", dict(delay_steps=3)),  # boundary consume (delay = tau)
    ("sparse_anchor", dict(sparse_k=0.5)),  # error feedback active
    ("sparse_anchor", dict(sparse_k=1.0)),
    ("gossip_full", {}),
    ("gossip_ring", {}),
    ("gossip_exp", {}),
    ("gossip_pushsum", dict(topology="ring")),
]
IDS = [f"{n}-{'-'.join(f'{k}{v}' for k, v in kw.items())}" for n, kw in CASES]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small CPU ops: torch's thread pool only contends with XLA's here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _cfg(name, kw, **extra):
    return dict(name=name, tau=3, alpha=0.6, packed=False, **kw, **extra)


def _pair(name, kw, optimizer="sgd"):
    """A JAX and a port per-leaf classifier experiment of one configuration,
    the port carrying the JAX experiment's built state."""
    j = JExperiment(task=JSpec(**SMALL), strategy=JAlgo(**_cfg(name, kw)), optimizer=JOpt(name=optimizer),
                    workers=M).build()
    p = Experiment(task=ClassificationSpec(**SMALL), strategy=AlgoConfig(**_cfg(name, kw)),
                   optimizer=OptimizerConfig(name=optimizer), workers=M, device="cpu").build()
    assert not isinstance(j.state.x, jstrategy.Packed) and isinstance(p.state.x, dict)
    p.state = _carry(j.state, p)
    return j, p


def _carry(jstate, p):
    return interop.state_from_numpy(_np(jstate), packing.layout_of(p.params))


@functools.lru_cache(maxsize=None)
def _after_one_round(case: int):
    """The JAX pair's state after one reference round (the workers differ, a
    collective is in flight); the port carrying it is made fresh by callers."""
    name, kw = CASES[case]
    j, p = _pair(name, kw)
    jstate, _ = j.step_fn(j.state, jloaders.round_batch(j.next_batch, j.tau))
    return j, p, jstate


def _slots(v, name="", out=None):
    """Every array of a (JAX or port) state or slot as float32/int numpy by
    name; planes by their leaves, trees by their leaves in flatten order
    (``None`` leaves skipped), so a packed and a per-leaf slot, or a JAX and
    a port slot, give the same names."""
    out = {} if out is None else out
    if v is None:
        return out
    if isinstance(v, Packed):
        for i, t in enumerate(leaf_views(v)):
            _slots(t, f"{name}/{i}", out)
    elif hasattr(v, "buffers") and hasattr(v, "layout"):  # a JAX plane
        from repro.parallel.packing import unpack

        _slots(unpack(v), name, out)
    elif isinstance(v, dict):
        for i, t in enumerate(tree_flatten(v)[0]):
            _slots(t, f"{name}/{i}", out)
    elif hasattr(v, "_fields"):
        for f in v._fields:
            _slots(getattr(v, f), f"{name}.{f}", out)
    elif isinstance(v, (tuple, list)):  # PowerSGD's packed q (a tuple in leaf order), gossip's (w, t)
        for i, a in enumerate(v):
            _slots(a, f"{name}/{i}", out)
    elif isinstance(v, torch.Tensor):
        out[name] = (v.float() if v.is_floating_point() else v).numpy().copy()
    else:
        a = np.asarray(v)
        out[name] = a.astype(np.float32) if a.dtype.kind == "f" or a.dtype.name == "bfloat16" else a
    return out


def _within_ulps(want, got, n, scale=None):
    """Every slot of ``got`` within ``n`` f32 ulps of its largest magnitude
    (or of ``scale[name]``'s) of ``want``; integer slots exactly."""
    assert sorted(want) == sorted(got)
    for k in want:
        if want[k].dtype.kind != "f":
            assert np.array_equal(got[k], want[k]), k
            continue
        ref = scale.get(k, want[k]) if scale else want[k]
        lim = n * np.spacing(np.float32(np.abs(ref).max())) if ref.size else 0.0
        err = np.abs(got[k].astype(np.float64) - want[k]).max() if want[k].size else 0.0
        assert err <= lim, (k, err, lim)


def _err_scale(slots):
    """The sparse anchor's error slots are bounded by the anchor's ulps."""
    return {k: slots[k.replace(".extra", ".z")] for k in slots if ".extra/" in k and k.replace(".extra", ".z") in slots}


# -- port per-leaf vs JAX per-leaf --------------------------------------------------------


@pytest.mark.parametrize("case", range(len(CASES)), ids=IDS)
def test_perleaf_boundaries_match_jax(case):
    """Three per-leaf boundaries in a row from a mid-training state (m = 4),
    against the reference's per-leaf ``boundary_round``; the transfer itself
    is bitwise and x is updated in place."""
    j, p, jstate = _after_one_round(case)
    pstate = _carry(jstate, p)
    want, got = _slots(jstate), _slots(pstate)
    assert sorted(want) == sorted(got) and all(np.array_equal(want[k], got[k]) for k in want)
    jx, jv, ji = jstate.x, jstate.vars, jstate.inflight
    px, pv, pi = pstate.x, pstate.vars, pstate.inflight
    for _ in range(3):
        jx, jv, ji = j.strategy_obj.boundary_round(jx, jv, ji)
        px, pv, pi = p.strategy_obj.boundary_round(px, pv, pi)
        assert px is pstate.x  # in place
    want, got = _slots((jx, jv, ji)), _slots((px, pv, pi))
    _within_ulps(want, got, 4, scale=_err_scale(want))


@pytest.mark.parametrize("case", range(len(CASES)), ids=IDS)
def test_perleaf_one_round_matches_jax(case):
    """A whole per-leaf round from the mid-training state: local steps with
    the gradient hook (sync_sgd, powersgd) and the mid-round hook
    (delayed_avg), then the two boundary phases."""
    j, p, jstate = _after_one_round(case)
    pstate = _carry(jstate, p)
    rb = jloaders.round_batch(j.next_batch, j.tau)
    jstate, jms = j.step_fn(jstate, rb)
    pstate, pms = p.step_fn(pstate, p.to_device(tuple(np.asarray(a) for a in rb)))
    want, got = _slots(jstate), _slots(pstate)
    assert sorted(want) == sorted(got)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(pms["loss"].numpy(), np.asarray(jms["loss"]), rtol=1e-5)


@pytest.mark.parametrize("case", range(len(CASES)), ids=IDS)
def test_perleaf_fit_matches_jax_over_20_rounds(case):
    name, kw = CASES[case]
    j, p = _pair(name, kw)
    jl, pl = np.asarray(j.fit(rounds=20).losses), np.asarray(p.fit(rounds=20).losses)
    np.testing.assert_allclose(pl, jl, rtol=1e-3 if kw.get("sparse_k", 1.0) < 1.0 else 1e-4)
    assert abs(p.evaluate()["test_acc"] - j.evaluate()["test_acc"]) <= 2 / SMALL["holdout"]
    assert isinstance(p.state.x, dict)


@pytest.mark.parametrize("case", range(len(CASES)), ids=IDS)
def test_perleaf_boundaries_bf16_match_jax(case):
    """bf16 MLP weights, the workers drifted apart by seeded noise, three
    per-leaf boundaries: within one bf16 ulp of each slot's largest
    magnitude, two for the sparse gossip push (the f32 slot, the sparse
    error feedback: 4 f32 ulps of the anchor's). Observed: bitwise, the push
    one ulp."""
    name, kw = CASES[case]
    jparams, _ = jclf.init_mlp(jax.random.PRNGKey(0), 64, 10, dtype=jnp.bfloat16)
    rng = np.random.default_rng(case)
    jstrat = jstrategy.make_strategy(JAlgo(**_cfg(name, kw)))
    x = jax.tree.map(lambda t: (jnp.tile(t[None], (M,) + (1,) * t.ndim).astype(jnp.float32)
                                + jnp.asarray(rng.normal(scale=0.05, size=(M,) + t.shape), jnp.float32)
                                ).astype(t.dtype), jparams)
    jv = jstrat.init_vars(x)
    ji = jstrat.init_inflight(x, jv)
    layout = packing.layout_of(interop.params_from_numpy(_np(jparams)))
    pstate = interop.state_from_numpy(_np(jmake_train_state(jparams, M, jsgd(), jstrat)._replace(x=x, vars=jv,
                                                                                                  inflight=ji)), layout)
    pstrat = make_strategy(AlgoConfig(**_cfg(name, kw)))
    px, pv, pi = pstate.x, pstate.vars, pstate.inflight
    assert next(iter(px.values())).dtype == torch.bfloat16
    for _ in range(3):
        x, jv, ji = jstrat.boundary_round(x, jv, ji)
        px, pv, pi = pstrat.boundary_round(px, pv, pi)
    want, got = _slots((x, jv, ji)), _slots((px, pv, pi))
    assert sorted(want) == sorted(got)
    for k in want:
        if want[k].dtype.kind != "f":
            assert np.array_equal(got[k], want[k]), k
            continue
        top = np.float32(np.abs(want[k]).max())
        if ".extra/" in k and name == "sparse_anchor":  # f32 error feedback
            lim = 4 * np.spacing(np.float32(np.abs(want[k.replace(".extra", ".z")]).max()))
        else:
            ulps = 2 if name.startswith("gossip") and kw.get("topology", name[7:]) != "full" else 1
            lim = ulps * np.ldexp(np.float32(1), np.frexp(top)[1] - 8) if top > 0 else 0.0
        assert np.abs(got[k] - want[k]).max() <= lim, (k, np.abs(got[k] - want[k]).max(), lim)


# -- the port's packed path against its per-leaf path, bitwise -------------------------------


def _leafy_params(seed=0, bf16=False):
    """A many-leaf mixed-shape tree (ragged and aligned leaves, a scalar);
    ``bf16`` makes its matrices and the first bias bf16: a second bucket."""
    rng = np.random.default_rng(seed)
    mat = torch.bfloat16 if bf16 else torch.float32
    p = {"s": torch.tensor(rng.normal(), dtype=torch.float32)}
    for i in range(6):
        p[f"w{i}"] = torch.from_numpy(rng.normal(size=(3 + i, 5 + 2 * i)).astype(np.float32)).to(mat)
        p[f"b{i}"] = torch.from_numpy(rng.normal(size=(5 + 2 * i,)).astype(np.float32)).to(mat if i == 0 else
                                                                                            torch.float32)
    p["aligned"] = torch.from_numpy(rng.normal(size=(2, 128)).astype(np.float32))
    return p


def _leafy_loss(params, batch):
    """0.5‖A·flat(x_i) − b_i‖² per worker, stacked: x's leaves (m, ...),
    A (m, 4, n), b (m, 4)."""
    A, b = batch
    m = A.shape[0]
    flat = torch.cat([t.reshape(m, -1).float() for t in tree_flatten(params)[0]], dim=1)
    r = torch.bmm(A, flat[:, :, None])[..., 0] - b
    loss = 0.5 * torch.sum(r * r, dim=-1)
    return loss, dict(loss=loss)


OPTS = {"sgd": lambda: sgd(momentum=0.9, nesterov=True, weight_decay=1e-4),
        "adamw": lambda: adamw(b1=0.9, b2=0.95, eps=1e-8, weight_decay=1e-4)}


def _run(cfg, optimizer, params, rounds=3, grad_clip=0.0, seed=1):
    """``rounds`` rounds of ``cfg`` (an AlgoConfig or a legacy Algorithm) on
    ``params`` from seeded batches; the final state."""
    strat = resolve_strategy(cfg)
    state = make_train_state(params, M, optimizer, strat)
    step = make_round_step(_leafy_loss, optimizer, strat, schedules.constant(0.03), grad_clip=grad_clip)
    n = sum(t.numel() for t in tree_flatten(params)[0])
    rng = np.random.default_rng(seed)
    for _ in range(rounds):
        A = torch.from_numpy(rng.normal(size=(strat.tau, M, 4, n)).astype(np.float32))
        b = torch.from_numpy(rng.normal(size=(strat.tau, M, 4)).astype(np.float32))
        state, _ = step(state, (A, b))
    return state


def _assert_bitwise(sp, sr):
    """x, the optimizer state, the in-flight value and vars of a packed and
    a per-leaf state, bit for bit (the packed Adam count is one scalar, the
    per-leaf count one per worker)."""
    assert isinstance(sp.x, Packed) and isinstance(sr.x, dict)
    want, got = _slots(sp._replace(step=None)), _slots(sr._replace(step=None))
    if ".opt.count" in want:
        assert (got.pop(".opt.count") == want.pop(".opt.count")).all()
    assert sorted(want) == sorted(got)
    for k in want:
        assert np.array_equal(got[k], want[k]), k


@pytest.mark.parametrize("opt_name", sorted(OPTS))
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "mixed_bf16"])
@pytest.mark.parametrize("case", range(len(CASES)), ids=IDS)
def test_packed_path_equals_perleaf_bitwise(case, bf16, opt_name):
    """Three full rounds (τ = 3) on a 14-leaf tree, packed and per leaf, from
    the same seeded batches: sgd without clipping, adamw with the gradients
    clipped to norm 0.5."""
    name, kw = CASES[case]
    cfg = AlgoConfig(name=name, tau=3, alpha=0.6, **kw)
    params = _leafy_params(case, bf16)
    clip = 0.5 if opt_name == "adamw" else 0.0
    sp = _run(cfg, OPTS[opt_name](), params, grad_clip=clip)
    sr = _run(dataclasses.replace(cfg, packed=False), OPTS[opt_name](), params, grad_clip=clip)
    _assert_bitwise(sp, sr)


@pytest.mark.parametrize("case", range(len(CASES)), ids=IDS)
def test_masked_boundary_packed_equals_perleaf_bitwise(case):
    """One round, then a boundary masked to workers {0, 2, 3} and one with
    worker 1 back (probe on): the packed and per-leaf boundaries agree bit
    for bit, and the dead row passes the masked boundary untouched."""
    name, kw = CASES[case]
    states = []
    for packed in (True, False):
        cfg = AlgoConfig(name=name, tau=3, alpha=0.6, packed=packed, **kw)
        state = _run(cfg, OPTS["sgd"](), _leafy_params(case, bf16=True), rounds=1)
        strat = make_strategy(cfg)
        x, v, infl = state.x, state.vars, state.inflight
        before = [t[1].clone() for t in (leaf_views(x) if packed else tree_flatten(x)[0])]
        x, v, infl, stats = strat.boundary_round(x, v, infl, probe=True,
                                                 membership=from_mask(np.array([1, 0, 1, 1], np.float32)))
        after = leaf_views(x) if packed else tree_flatten(x)[0]
        assert all(torch.equal(a[1], b) for a, b in zip(after, before)) and torch.isfinite(stats.drift)
        x, v, infl = strat.boundary_round(x, v, infl)
        states.append(state._replace(x=x, vars=v, inflight=infl))
    _assert_bitwise(*states)


def test_packed_strategy_with_a_perleaf_optimizer_runs_per_leaf():
    """An optimizer with no packed step under a packed strategy: x and the
    optimizer state stay per leaf, the strategy's slots packed (the
    reference's mixed state), and the run equals the all-per-leaf one."""
    base = OPTS["sgd"]()
    leafy_opt = Optimizer(init=base.init, step=base.step)
    assert not packed_capable(leafy_opt)
    for name, kw in (("overlap_local_sgd", {}), ("delayed_avg", dict(delay_steps=2)), ("powersgd", {}),
                     ("gossip_ring", {})):
        cfg = AlgoConfig(name=name, tau=3, alpha=0.6, **kw)
        mixed = _run(cfg, leafy_opt, _leafy_params(3))
        assert isinstance(mixed.x, dict) and isinstance(mixed.opt.momentum, dict)
        ref = _run(dataclasses.replace(cfg, packed=False), leafy_opt, _leafy_params(3))
        for a, b in zip(tree_flatten(mixed.x)[0], tree_flatten(ref.x)[0]):
            assert torch.equal(a, b), name


def test_perleaf_state_migrates_into_the_packed_engine():
    """A state whose x is per leaf (its optimizer state and slots packed)
    handed to the packed engine: the first round adopts the plane and runs
    as the plane-resident state does."""
    cfg = AlgoConfig(name="overlap_local_sgd", tau=3, alpha=0.6)
    opt, strat = OPTS["sgd"](), make_strategy(cfg)
    state = make_train_state(_leafy_params(5), M, opt, strat)
    twin = make_train_state(_leafy_params(5), M, opt, strat)
    twin = twin._replace(x=ptree.tree_map(torch.clone, packing.unpack(twin.x)))
    step = make_round_step(_leafy_loss, opt, strat, schedules.constant(0.03))
    n = sum(t.numel() for t in tree_flatten(_leafy_params(5))[0])
    batch = (torch.from_numpy(np.random.default_rng(0).normal(size=(3, M, 4, n)).astype(np.float32)),
             torch.zeros(3, M, 4))
    out1, _ = step(state, batch)
    out2, _ = step(twin, batch)
    assert isinstance(out2.x, Packed)
    for a, c in zip(out1.x.buffers, out2.x.buffers):
        assert torch.equal(a, c)


# -- the legacy shims -------------------------------------------------------------------------

LEGACY = [("overlap_local_sgd", dict(anchor_beta=0.0)), ("overlap_local_sgd", dict(anchor_beta=0.7)),
          ("local_sgd", {}), ("sync_sgd", {}), ("easgd", {}), ("cocod", {}), ("powersgd", {})]


@pytest.mark.parametrize("name,kw", LEGACY, ids=[f"{n}-{kw}" for n, kw in LEGACY])
def test_legacy_algorithm_equals_native_perleaf_strategy(name, kw):
    """Each legacy ``Algorithm`` through ``resolve_strategy`` (wrapped in
    ``LegacyStrategy``) against its native per-leaf strategy, three rounds:
    x bitwise, and the anchor (legacy: ``vars.z``; native: the in-flight
    value, or EASGD's ``vars.z``) bitwise."""
    cfg = AlgoConfig(name=name, tau=3, alpha=0.6, **kw)
    with pytest.warns(DeprecationWarning):
        algo = palgorithms.make_algorithm(cfg)
    legacy = resolve_strategy(algo)
    assert isinstance(legacy, LegacyStrategy) and not legacy.packed and legacy.tau == make_strategy(cfg).tau
    sl = _run(algo, OPTS["sgd"](), _leafy_params(7))
    sn = _run(dataclasses.replace(cfg, packed=False), OPTS["sgd"](), _leafy_params(7))
    for a, b in zip(tree_flatten(sl.x)[0], tree_flatten(sn.x)[0]):
        assert torch.equal(a, b)
    if name in ("overlap_local_sgd", "easgd"):
        anchor = sn.vars.z if name == "easgd" else sn.inflight
        for a, b in zip(tree_flatten(sl.vars.z)[0], tree_flatten(anchor)[0]):
            assert torch.equal(a, b)
    if name == "powersgd":
        for a, b in zip(tree_flatten(sl.vars.extra.err)[0], tree_flatten(sn.vars.extra.err)[0]):
            assert torch.equal(a, b)


def test_legacy_algorithms_match_jax_legacy():
    """The port's legacy overlap (β = 0.7) and cocod against the reference's
    own legacy ``Algorithm`` on the classifier, 5 rounds: losses rtol 1e-4."""
    from repro.core import algorithms as jalgorithms

    for name in ("overlap_local_sgd", "cocod"):
        with pytest.warns(DeprecationWarning):
            jalgo = jalgorithms.make_algorithm(JAlgo(name=name))
            palgo = palgorithms.make_algorithm(AlgoConfig(name=name))
        j = JExperiment(task=JSpec(**SMALL), strategy=jalgo, workers=M).build()
        p = Experiment(task=ClassificationSpec(**SMALL), strategy=palgo, workers=M, device="cpu").build()
        p.state = _carry(j.state, p)
        np.testing.assert_allclose(p.fit(rounds=5).losses, j.fit(rounds=5).losses, rtol=1e-4)


def test_legacy_strategy_refuses_a_membership_and_as_strategy_refuses_others():
    with pytest.warns(DeprecationWarning):
        legacy = resolve_strategy(palgorithms.make_algorithm(AlgoConfig()))
    x = {"w": torch.ones(2, 3)}
    with pytest.raises(ValueError, match="membership"):
        legacy.boundary_round(x, legacy.init_vars(x), None, membership=from_mask(np.array([1, 0], np.float32)))
    with pytest.raises(TypeError, match="CommStrategy or Algorithm"):
        resolve_strategy(object())
    with pytest.warns(DeprecationWarning), pytest.raises(ValueError, match="unknown algorithm"):
        palgorithms.make_algorithm(AlgoConfig(name="gossip_ring"))


def test_deprecation_warnings():
    """Legacy names taken from ``repro_torch.core`` warn, as
    ``make_algorithm()`` and ``repro_torch.core.adaptive`` do; importing the
    package itself does not."""
    import repro_torch.core as core

    for name in core._LEGACY_NAMES:
        with pytest.warns(DeprecationWarning, match="deprecated single-hook"):
            obj = getattr(core, name)
        assert obj is getattr(palgorithms, name)
    with pytest.warns(DeprecationWarning, match="moved to repro_torch.control"):
        from repro_torch.core.adaptive import TauScheduledTrainer  # noqa: F401
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        make_strategy(AlgoConfig())
    with pytest.raises(AttributeError):
        core.no_such_name  # noqa: B018


# -- the matrix form (eq. 8) and mixing ---------------------------------------------------------


def test_mixing_matches_jax():
    for m, alpha in ((4, 0.6), (7, 0.5), (16, 0.3)):
        P, v = mixing.mixing_matrix(m, alpha), mixing.fixed_vector(m, alpha)
        assert np.array_equal(P, jmixing.mixing_matrix(m, alpha)) and np.array_equal(v, jmixing.fixed_vector(m, alpha))
        assert mixing.zeta(P, v) == jmixing.zeta(P, v) and mixing.zeta(P, v) <= 1 - alpha + 1e-12
        assert np.array_equal(mixing.easgd_mixing_matrix(m, alpha), jmixing.easgd_mixing_matrix(m, alpha))
        assert np.allclose(P.sum(axis=0), 1.0) and np.allclose(P @ v, v)


def test_perleaf_overlap_matches_the_matrix_form():
    """The port's per-leaf Overlap-Local-SGD (β = 0, SGD without momentum)
    ≡ eq. (8) X_{k+1} = (X_k − γ G_k) W_k, every round (the reference's
    ``test_overlap_matches_matrix_form_exactly``), for the native strategy
    and the legacy shim."""
    d, tau, alpha, lr = 6, 3, 0.6, 0.05
    x0 = np.random.default_rng(0).normal(size=d).astype(np.float32)

    def quad_loss(params, batch):
        A, b = batch
        r = torch.bmm(A, params["x"][:, :, None])[..., 0] - b
        loss = 0.5 * torch.sum(r * r, dim=-1)
        return loss, dict(loss=loss)

    cfg = AlgoConfig(name="overlap_local_sgd", tau=tau, alpha=alpha, anchor_beta=0.0, packed=False)
    with pytest.warns(DeprecationWarning):
        legacy = palgorithms.make_algorithm(dataclasses.replace(cfg, packed=True))
    for strat in (make_strategy(cfg), legacy):
        opt = sgd(momentum=0.0, nesterov=False, weight_decay=0.0)
        state = make_train_state({"x": torch.from_numpy(x0)}, M, opt, strat)
        step = make_round_step(quad_loss, opt, strat, schedules.constant(lr))
        sim = mixing.MatrixFormSim(x0.astype(np.float64), M, alpha, tau, lr)
        rng = np.random.default_rng(42)
        for _ in range(4):
            A = rng.normal(size=(tau, M, d, d)).astype(np.float32)
            b = rng.normal(size=(tau, M, d)).astype(np.float32)
            state, _ = step(state, (torch.from_numpy(A), torch.from_numpy(b)))
            for k in range(tau):
                grads = np.stack([A[k, i].T @ (A[k, i] @ sim.locals[:, i] - b[k, i]) for i in range(M)], axis=1)
                sim.step(grads)
            np.testing.assert_allclose(state.x["x"].numpy().T, sim.locals, rtol=1e-5, atol=1e-5)
            anchor = state.vars.z if isinstance(strat, palgorithms.Algorithm) else state.inflight
            np.testing.assert_allclose(anchor["x"].numpy(), sim.anchor, rtol=1e-5, atol=1e-5)
        y = (1 - alpha) * np.mean(state.x["x"].numpy(), axis=0) + alpha * anchor["x"].numpy()
        np.testing.assert_allclose(sim.virtual_sequence(), y, rtol=1e-5, atol=1e-5)


# -- utils/tree, the per-leaf optimizers, the pullback ---------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tree_helpers_match_jax(dtype, rng):
    a = {"u": rng.normal(size=(3, 4)).astype(np.float32), "v": {"w": rng.normal(size=(5,)).astype(np.float32)}}
    b = jax.tree.map(lambda t: rng.normal(size=t.shape).astype(np.float32), a)
    ja, jb = (jax.tree.map(lambda t: jnp.asarray(t, dtype), t) for t in (a, b))
    ta, tb = (interop.params_from_numpy(_np(t)) for t in (ja, jb))
    s = jnp.float32(0.37)
    pairs = [
        (jtree.tree_zeros_like(ja), ptree.tree_zeros_like(ta)),
        (jtree.tree_add(ja, jb), ptree.tree_add(ta, tb)),
        (jtree.tree_sub(ja, jb), ptree.tree_sub(ta, tb)),
        (jtree.tree_scale(ja, 0.3), ptree.tree_scale(ta, 0.3)),
        (jtree.tree_scale(ja, s), ptree.tree_scale(ta, torch.tensor(0.37))),
        (jtree.tree_axpy(0.3, ja, jb), ptree.tree_axpy(0.3, ta, tb)),
        (jtree.tree_lerp(ja, jb, 0.6), ptree.tree_lerp(ta, tb, 0.6)),
        (jtree.tree_lerp(ja, jb, s), ptree.tree_lerp(ta, tb, torch.tensor(0.37))),
    ]
    for want, got in pairs:
        for w, g in zip(jax.tree.leaves(want), tree_flatten(got)[0]):
            assert g.dtype == getattr(torch, dtype)
            assert np.array_equal(g.float().numpy(), np.asarray(w.astype(jnp.float32)))
    # the sums run in other orders: within 1e-6 of the sum of the magnitudes
    mag = sum(np.sum(np.abs(np.asarray(x, np.float32) * np.asarray(y, np.float32)))
              for x, y in zip(jax.tree.leaves(ja), jax.tree.leaves(jb)))
    np.testing.assert_allclose(ptree.tree_dot(ta, tb).numpy(), np.asarray(jtree.tree_dot(ja, jb)), rtol=0,
                               atol=1e-6 * mag)
    np.testing.assert_allclose(ptree.tree_l2_norm(ta).numpy(), np.asarray(jtree.tree_l2_norm(ja)), rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("opt_name", ["sgd", "adamw"])
def test_perleaf_step_with_clipping_matches_jax_vmap(opt_name, dtype, rng):
    """Four steps of the per-leaf optimizer on worker-stacked params, the
    gradients clipped per worker to norm 1.0 first, against
    ``jax.vmap(opt.step)`` after ``jax.vmap(clip_by_global_norm)``."""
    make_j = {"sgd": lambda: jsgd(0.9, True, 1e-4), "adamw": lambda: jadamw(0.9, 0.95, 1e-8, 1e-4)}[opt_name]
    jopt, popt = make_j(), OPTS[opt_name]()
    shapes = {"a": (M, 5, 7), "b": (M, 7), "c": (M,)}
    x = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    jx = jax.tree.map(lambda t: jnp.asarray(t, dtype), x)
    px = interop.params_from_numpy(_np(jx))
    jst, pst = jax.vmap(jopt.init)(jx), popt.init(px)
    lr = jnp.float32(0.05)
    for _ in range(4):
        g = {k: rng.normal(scale=2.0, size=s).astype(np.float32) for k, s in shapes.items()}
        jg = jax.tree.map(lambda t: jnp.asarray(t, dtype), g)
        jg, jnorm = jax.vmap(lambda t: jclip(t, 1.0))(jg)
        pg = interop.params_from_numpy(_np(jax.tree.map(lambda t: jnp.asarray(t, dtype), g)))
        pnorm = clip_by_global_norm_(pg, 1.0)
        np.testing.assert_allclose(pnorm.numpy(), np.asarray(jnorm), rtol=1e-6)
        _close(_np(jg), pg, dtype, ulps=2)
        jst, jx = jax.vmap(lambda o, xi, gi: jopt.step(o, xi, gi, lr))(jst, jx, jg)
        # the port steps from the reference's clipped gradients: the step alone is compared
        pst, px = popt.step(pst, px, interop.params_from_numpy(_np(jg)), torch.tensor(0.05))
        _close(_np(jx), px, dtype, ulps=0 if opt_name == "sgd" else 2)
    if opt_name == "adamw":
        assert pst.count.shape == (M,) and np.array_equal(pst.count.numpy(), np.asarray(jst.count))
        _close(_np(jst.mu), pst.mu, "float32", ulps=2)
    else:
        _close(_np(jst.momentum), pst.momentum, dtype, ulps=0)


def _close(want, got, dtype, ulps):
    """Leaf by leaf: f32 within ``ulps`` f32 ulps of |want|, bf16 within one
    bf16 ulp (bitwise when ``ulps`` is 0)."""
    for w, g in zip(jax.tree.leaves(want), tree_flatten(got)[0]):
        w = np.asarray(w).astype(np.float32)
        g = g.float().numpy()
        if ulps == 0:
            assert np.array_equal(g, w)
        elif dtype == "float32":
            assert (np.abs(g - w) <= ulps * np.spacing(np.abs(w))).all()
        else:
            _, e = np.frexp(np.abs(w))
            assert (np.abs(g - w) <= np.ldexp(np.float32(1), e - 8)).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pullback_tree_broadcast_matches_reference_pullback(dtype, rng):
    """The row form: stacked x leaves, unstacked z leaves, in place, bitwise
    the reference's ``_pullback`` (K5 vmapped over the workers); and a
    stacked z (gossip's per-worker anchor), bitwise its vmapped pullback."""
    x = {"a": rng.normal(size=(M, 3, 5)).astype(np.float32), "b": {"c": rng.normal(size=(M,)).astype(np.float32)}}
    z = jax.tree.map(lambda t: t[0] + 0.5, x)
    jx, jz = (jax.tree.map(lambda t: jnp.asarray(t, dtype), t) for t in (x, z))
    want = jstrategy._pullback(jx, jz, 0.6)
    px, pz = interop.params_from_numpy(_np(jx)), interop.params_from_numpy(_np(jz))
    leaves = tree_flatten(px)[0]
    out = am_ops.pullback_tree(px, pz, 0.6)
    assert all(a is b for a, b in zip(tree_flatten(out)[0], leaves))  # in place, the same tensors
    _close(_np(want), out, dtype, ulps=0)
    zs = jax.tree.map(lambda t: t[::-1], jx)
    want = jax.vmap(lambda xi, zi: jax.tree.map(lambda a, b: jstrategy.anchor_ops.anchor_mix(a, b, 0.3), xi, zi))(
        jx, zs)
    px = interop.params_from_numpy(_np(jx))
    _close(_np(want), am_ops.pullback_tree(px, interop.params_from_numpy(_np(zs)), 0.3), dtype, ulps=0)
    with pytest.raises(ValueError, match="z must match"):
        am_ops.anchor_mix(torch.zeros(M, 3), torch.zeros(4), 0.6)


# -- Experiment per leaf: adaptive τ, faults, serving surfaces, checkpoints --------------------------


@pytest.mark.parametrize("name", ["overlap_local_sgd", "gossip_ring"])
def test_perleaf_adaptive_and_faulted_fits_match_jax(name):
    """Worker 1 crashed for rounds 1-2 under a controller, per leaf: the fault
    log and the τ schedule as the reference's, then an adaptive-only fit."""
    j, p = _pair(name, {})
    fields = dict(tau=2, tau_min=1, tau_max=8)
    jres = j.fit(rounds=4, faults=JFaultPlan.parse("crash:1@1-3", m=M, seed=0), adaptive_tau=JTauController(**fields))
    pres = p.fit(rounds=4, faults=FaultPlan.parse("crash:1@1-3", m=M, seed=0), adaptive_tau=TauController(**fields))
    assert pres.fault_log == jres.fault_log and isinstance(p.state.x, dict)
    keys = ("round", "tau", "decision", "next_tau", "fault")
    assert [{k: h.get(k) for k in keys} for h in pres.tau_schedule] == [{k: h.get(k) for k in keys}
                                                                      for h in jres.tau_schedule]
    for key in ("drift", "scale"):
        np.testing.assert_allclose([h[key] for h in pres.tau_schedule], [h[key] for h in jres.tau_schedule],
                                   rtol=1e-5)
    np.testing.assert_allclose(pres.losses, jres.losses, rtol=1e-4)
    jres = j.fit(rounds=3, adaptive_tau=JTauController(tau=1, tau_min=1, tau_max=8, lo=0.05, hi=0.5))
    pres = p.fit(rounds=3, adaptive_tau=TauController(tau=1, tau_min=1, tau_max=8, lo=0.05, hi=0.5))
    assert [h["decision"] for h in pres.tau_schedule] == [h["decision"] for h in jres.tau_schedule]
    np.testing.assert_allclose(pres.losses, jres.losses, rtol=1e-4)
    assert abs(p.evaluate()["test_acc"] - j.evaluate()["test_acc"]) <= 2 / SMALL["holdout"]


def test_perleaf_experiment_surfaces():
    """consensus() works per leaf; consensus_plane() and anchor_plane()
    raise as in the reference; a non-packed-capable optimizer trains per
    leaf through ``Experiment``; offload with a per-leaf state raises."""
    exp = Experiment(task=ClassificationSpec(**SMALL), strategy=AlgoConfig(packed=False), workers=M, device="cpu")
    res = exp.fit(rounds=3)
    assert np.isfinite(res.losses).all() and isinstance(exp.state.x, dict)
    cons = exp.consensus()
    assert sorted(cons) == sorted(exp.params) and cons["w0"].dtype == torch.float32
    with pytest.raises(ValueError, match="plane-resident"):
        exp.consensus_plane()
    with pytest.raises(ValueError, match="anchor_plane"):
        exp.anchor_plane()
    base = sgd()
    leafy = Experiment(task=ClassificationSpec(**SMALL), optimizer=Optimizer(init=base.init, step=base.step),
                       schedule=schedules.constant(0.1), workers=M, device="cpu")
    assert np.isfinite(leafy.fit(rounds=2).losses).all() and isinstance(leafy.state.x, dict)
    assert leafy.evaluate()["test_acc"] > 0.1
    with pytest.raises(ValueError, match="offload requires a packed strategy"):  # as the reference
        Experiment(task=ClassificationSpec(**SMALL), strategy=AlgoConfig(packed=False, offload=True), workers=M,
                   device="cpu").build()


def _ref_state(name, opt):
    j = JExperiment(task=JSpec(**SMALL), strategy=JAlgo(name=name, packed=False), optimizer=JOpt(name=opt),
                    workers=M).build()
    jstate, _ = j.step_fn(j.state, jloaders.round_batch(j.next_batch, j.tau))
    return j, jstate


@pytest.mark.parametrize("name,opt", [("overlap_local_sgd", "adamw"), ("gossip_ring", "sgd"), ("cocod", "sgd"),
                                      ("powersgd", "sgd")])
def test_perleaf_checkpoint_both_ways(tmp_path, name, opt):
    """The port's per-leaf state saved → the reference restores it into its
    per-leaf template bit for bit, and the reference's per-leaf file
    restores into the port's per-leaf template bit for bit."""
    j, jstate = _ref_state(name, opt)
    p = Experiment(task=ClassificationSpec(**SMALL), strategy=AlgoConfig(name=name, packed=False),
                   optimizer=OptimizerConfig(name=opt), workers=M, device="cpu").build()
    pstate = _carry(jstate, p)
    path = str(tmp_path / "port.npz")
    checkpoint.save(path, pstate)
    back = jrestore(path, j.state)
    want, got = _slots(jstate), _slots(back)
    assert sorted(want) == sorted(got) and all(np.array_equal(want[k], got[k]) for k in want)
    path = str(tmp_path / "ref.npz")
    jsave(path, jstate)
    restored = checkpoint.restore(path, p.state)
    got = _slots(restored)
    assert sorted(want) == sorted(got) and all(np.array_equal(want[k], got[k]) for k in want)
    assert isinstance(restored.x, dict)
    p.state = restored
    assert np.isfinite(p.fit(rounds=1).losses).all()


def test_make_strategy_builds_every_name_per_leaf():
    """Every name and alias of the reference, per leaf: it builds, its
    boundary runs, and an Experiment trains with it."""
    names = sorted(jstrategy.STRATEGIES) + sorted(jstrategy._ALIASES)
    for name in names:
        strat = make_strategy(AlgoConfig(name=name, packed=False))
        assert not strat.packed and type(strat).__name__ == type(jstrategy.make_strategy(JAlgo(name=name))).__name__
        exp = Experiment(task=ClassificationSpec(n=600, holdout=100), strategy=AlgoConfig(name=name, packed=False),
                         workers=3, device="cpu")
        assert np.isfinite(exp.fit(rounds=2).losses).all(), name
    assert isinstance(AlgoVars(), tuple)


def test_consensus_metrics_match_jax():
    """``metrics``'s ``consensus_dist`` (the base strategy's and the legacy
    shim's) on a mid-training per-leaf state: rtol 1e-6 (sums in other
    orders)."""
    from repro.core import algorithms as jalgorithms

    j, p, jstate = _after_one_round(1)
    pstate = _carry(jstate, p)
    want = float(j.strategy_obj.metrics(jstate.x, jstate.vars)["consensus_dist"])
    got = float(p.strategy_obj.metrics(pstate.x, pstate.vars)["consensus_dist"])
    np.testing.assert_allclose(got, want, rtol=1e-6)
    with pytest.warns(DeprecationWarning):
        jalgo, palgo = jalgorithms.make_algorithm(JAlgo()), palgorithms.make_algorithm(AlgoConfig())
    legacy = resolve_strategy(palgo)
    np.testing.assert_allclose(float(legacy.metrics(pstate.x, pstate.vars)["consensus_dist"]),
                               float(jalgo.metrics(jstate.x, jstate.vars)["consensus_dist"]), rtol=1e-6)
    assert got > 0


def test_perleaf_path_imports_no_jax():
    """The per-leaf path, a legacy Algorithm, ``core.mixing`` and
    ``utils.tree`` with any import of JAX failing: a subprocess."""
    import subprocess
    import sys
    import textwrap
    from pathlib import Path

    src = Path(__file__).resolve().parents[1] / "src"
    code = textwrap.dedent(
        f"""
        import sys, warnings
        sys.path.insert(0, {str(src)!r})
        sys.modules["jax"] = None
        from repro_torch.api import ClassificationSpec, Experiment
        from repro_torch.config import AlgoConfig
        from repro_torch.core import algorithms, mixing
        from repro_torch.utils import tree
        exp = Experiment(task=ClassificationSpec(n=600, holdout=100), strategy=AlgoConfig(packed=False), workers=2,
                         device="cpu")
        print(len(exp.fit(rounds=2).losses))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            algo = algorithms.make_algorithm(AlgoConfig(name="easgd"))
        exp = Experiment(task=ClassificationSpec(n=600, holdout=100), strategy=algo, workers=2, device="cpu")
        print(len(exp.fit(rounds=2).losses), mixing.mixing_matrix(2, 0.5).shape[0])
        bad = sorted(m for m in sys.modules if m == "repro" or m.startswith("repro."))
        assert not bad, bad
        """
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["2", "2", "3"]
