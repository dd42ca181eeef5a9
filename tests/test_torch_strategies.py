"""The port's remaining strategies (repro_torch) against the JAX reference,
on the CPU: EASGD, CoCoD, delayed averaging, sparse anchor (LOSCAR),
PowerSGD and push-sum gossip (full, ring, exp), their topologies, and the
state transfer of every strategy slot.

Both packages get the same inputs: numpy data from one seed and the
reference's ``Experiment.build()`` state (or the state after one of its
rounds, where the workers differ), carried over bit for bit by
``repro_torch.interop``. Stated tolerances and why:

* topologies, membership composition, state transfer, the quantile of a
  large leaf: exact;
* boundaries (three in a row for gossip and sparse anchor), f32: every
  slot within 4 ulps of its largest magnitude, and the sparse anchor's
  error plane within 4 ulps of the anchor's — the worker means of the two
  packages sum in other orders (the port: rows 0 .. m−1 in order; XLA: its
  own), the gossip mix ``Peff @ x`` likewise, and the error Δ − s = mean −
  z + e keeps the ulp of its operands, not of its small result (observed
  ≤ 3 ulps);
* one round from a mid-training state: rtol 1e-5, atol 1e-6 on every slot
  (as ``tests/test_torch_training.py``; observed ≤ 5 ulps);
* 20 rounds of fit: losses rtol 1e-4 (observed ≤ 2.5e-7) and test accuracy
  within 2 / holdout, except sparse anchor at k = 0.25: rtol 1e-3 (observed
  1.3e-4), because a top-k selection is discontinuous — an element within
  an ulp of its leaf's threshold may be sent by one package and held back
  as error feedback by the other, and the fit carries that difference on;
* boundaries in bf16: see ``test_boundaries_bf16_match_jax``; the LM
  round in bf16: see ``test_lm_gossip_round_bf16_matches_jax``;
* the gossip boundary's one pass (K5's gossip form) against the reference's
  packed boundary on seeded planes: the f32 and bf16 bounds above (4 f32
  ulps of each slot's largest magnitude; one bf16 ulp of max|x|).

Sparse anchor is held against the reference's per-leaf oracle
(``packed=False``, ``repro.core.strategy.sparsify_topk``). Its tie rule:
an element whose magnitude equals its leaf's threshold is kept (``>=``),
so a leaf may send more than k·size elements; leaves of one element are
sent whole.
"""
import dataclasses

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
from repro.core import make_strategy as jmake_strategy
from repro.core import strategy as jstrategy
from repro.core import topology as jtopology
from repro.fault import membership as jmembership
from repro.data import loaders as jloaders
from repro.models import classifier as jclf
from repro.optim import from_config as jopt_from_config
from repro.optim import schedules as jsched
from repro.parallel import packing as jpacking
from repro.parallel.packing import Packed as JPacked
from repro.training import make_round_step as jmake_round_step
from repro.training import make_train_state as jmake_train_state
from repro_torch import interop
from repro_torch.api import ClassificationSpec, Experiment, TokenStream
from repro_torch.config import AlgoConfig, OptimizerConfig, get_arch
from repro_torch.core import STRATEGIES, make_strategy, sparsify_topk_, topology
from repro_torch.core import strategy as pstrategy
from repro_torch.core.strategy import _ALIASES, _quantile_linear
from repro_torch.fault import membership as pmembership
from repro_torch.kernels.anchor_mix import ops as am_ops
from repro_torch.launch import train as train_cli
from repro_torch.models import classifier as clf
from repro_torch.optim import schedules
from repro_torch.parallel import packing
from repro_torch.parallel.packing import Packed

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


def _pair(strategy, workers=5, optimizer="sgd"):
    """A JAX and a port classifier experiment of one configuration; the
    port's state is the JAX experiment's built state."""
    j = JExperiment(task=JSpec(**SMALL), strategy=JAlgo(**strategy), optimizer=JOpt(name=optimizer),
                    workers=workers).build()
    p = Experiment(task=ClassificationSpec(**SMALL), strategy=AlgoConfig(**strategy),
                   optimizer=OptimizerConfig(name=optimizer), workers=workers, device="cpu").build()
    p.state = _carry(j.state, p)
    return j, p


def _carry(jstate, p):
    return interop.state_from_numpy(_np(jstate), packing.layout_of(p.params))


def _mid_training(strategy, workers=5):
    """The pair after one JAX round (the workers differ, a collective is in
    flight), the port carrying that state."""
    j, p = _pair(strategy, workers)
    jstate, _ = j.step_fn(j.state, jloaders.round_batch(j.next_batch, j.tau))
    return j, p, jstate, _carry(jstate, p)


def _slots(v, name="", out=None):
    """Every array of a (JAX or port) state or slot, as numpy by name:
    floats as float32, the rest as they are. PowerSGD's per-leaf factors
    (a tree in JAX, a tuple in the port) are compared in leaf order."""
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


# -- topologies ---------------------------------------------------------------------


@pytest.mark.parametrize("m", range(1, 10))
@pytest.mark.parametrize("name", ["full", "ring", "exp"])
def test_topology_matches_jax(name, m):
    j, t = jtopology.make_topology(name, m), topology.make_topology(name, m)
    assert t.mats.dtype == j.mats.dtype and np.array_equal(t.mats, j.mats)
    assert (t.num_phases, t.degree, t.is_full, t.m) == (j.num_phases, j.degree, j.is_full, j.m)
    mask = np.ones(m, np.float32)
    mask[np.random.default_rng(m).permutation(m)[: m // 3]] = 0.0
    for r in range(2 * t.num_phases + 1):
        assert np.array_equal(t.matrix(r), j.matrix(r)) and np.array_equal(t.in_mask(r), j.in_mask(r))
        want = np.asarray(jtopology.compose_membership(j.matrix(r), jnp.asarray(mask)))
        got = topology.compose_membership(t.matrix(r), torch.from_numpy(mask))
        assert got.dtype == torch.float32 and np.array_equal(got.numpy(), want)
    assert topology.cached_topology(name, m) is topology.cached_topology(name, m)


def test_topology_rejects_bad_arguments():
    with pytest.raises(ValueError, match="unknown topology"):
        topology.make_topology("star", 4)
    with pytest.raises(ValueError, match="at least one worker"):
        topology.make_topology("ring", 0)


# -- every name builds ----------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(jstrategy.STRATEGIES) + sorted(jstrategy._ALIASES))
def test_every_reference_name_runs_on_cpu(name, capsys):
    """Each strategy name and alias of the reference builds, fits the
    classifier and trains the reduced LM through the CLI on the CPU."""
    assert sorted(STRATEGIES) == sorted(jstrategy.STRATEGIES) and _ALIASES == jstrategy._ALIASES
    strat = make_strategy(AlgoConfig(name=name))
    assert type(strat).__name__ == type(jmake_strategy(JAlgo(name=name))).__name__ and strat.tau == jmake_strategy(JAlgo(name=name)).tau
    exp = Experiment(task=ClassificationSpec(n=600, holdout=100), strategy=name, workers=3, device="cpu")
    assert all(np.isfinite(exp.fit(rounds=2).losses))
    train_cli.main(["--arch", "qwen2-7b", "--algo", name, "--rounds", "1", "--device", "cpu", "--seq", "16",
                    "--workers", "2"])
    assert "round    0  loss" in capsys.readouterr().out


# -- boundaries against the reference ------------------------------------------------

BOUNDARY_CASES = [
    dict(name="easgd"),
    dict(name="cocod"),
    dict(name="delayed_avg", delay_steps=1),
    dict(name="delayed_avg", delay_steps=2),
    dict(name="gossip_full"),
    dict(name="gossip_ring"),
    dict(name="gossip_exp"),
    dict(name="sgp", topology="exp"),
    dict(name="gossip_pushsum", topology="ring"),
]


@pytest.mark.parametrize("strategy", BOUNDARY_CASES, ids=lambda s: "-".join(str(v) for v in s.values()))
def test_boundaries_match_jax(strategy):
    """Three boundaries in a row from a mid-training state (m = 5: a ring
    of five, exp with three phases), against the reference's packed
    boundary; the transfer itself is bitwise."""
    j, p, jstate, pstate = _mid_training(strategy)
    want, got = _slots(jstate), _slots(pstate)
    assert all(np.array_equal(want[k], got[k]) for k in want) and sorted(want) == sorted(got)
    jx, jv, ji = jstate.x, jstate.vars, jstate.inflight
    px, pv, pi = pstate.x, pstate.vars, pstate.inflight
    for _ in range(3):
        jx, jv, ji = j.strategy_obj.boundary_round(jx, jv, ji)
        px, pv, pi = p.strategy_obj.boundary_round(px, pv, pi)
        assert px is pstate.x  # in place
    _within_ulps(_slots((jx, jv, ji)), _slots((px, pv, pi)), 4)


@pytest.mark.parametrize("strategy", [dict(name="easgd"), dict(name="cocod"), dict(name="sparse_anchor", sparse_k=0.25),
                                      dict(name="gossip_ring")], ids=lambda s: s["name"])
def test_boundaries_bf16_match_jax(strategy):
    """bf16 planes (the MLP's weights in bf16, m = 4), three boundaries after
    one reference round: bitwise — EASGD's z lerp rounds to bf16 after each
    op in both packages, the rebase and the sparse delta run in f32 —
    except gossip, whose f32 mix sums in another order before its bf16
    rounding: within one bf16 ulp of max|x| (observed 1/8)."""
    m = 4
    jparams, _ = jclf.init_mlp(jax.random.PRNGKey(0), 64, 10, dtype=jnp.bfloat16)
    jstrat, jopt = jmake_strategy(JAlgo(**strategy)), jopt_from_config(JOpt())
    jstate = jmake_train_state(jparams, m, jopt, jstrat)
    splits = jloaders.make_classification_splits(m, **SMALL)
    step = jax.jit(jmake_round_step(jclf.mlp_loss, jopt, jstrat, jsched.constant(0.1)))
    jstate, _ = step(jstate, jloaders.round_batch(jloaders.classification_batch_fn(splits, 32), 2))
    tparams = clf.init_mlp(torch.Generator().manual_seed(0), 64, 10, dtype=torch.bfloat16)
    pstate = interop.state_from_numpy(_np(jstate), packing.layout_of(tparams))
    assert pstate.x.buffers[0].dtype == torch.bfloat16
    pstrat = make_strategy(AlgoConfig(**strategy))
    jx, jv, ji = jstate.x, jstate.vars, jstate.inflight
    px, pv, pi = pstate.x, pstate.vars, pstate.inflight
    for _ in range(3):
        jx, jv, ji = jstrat.boundary_round(jx, jv, ji)
        px, pv, pi = pstrat.boundary_round(px, pv, pi)
    want, got = _slots((jx, jv, ji)), _slots((px, pv, pi))
    assert sorted(want) == sorted(got)
    lim = np.ldexp(np.float32(1), np.frexp(np.abs(want["[0]0"]).max())[1] - 8) if strategy["name"] == "gossip_ring" else 0
    for k in want:
        assert np.abs(got[k] - want[k]).max() <= lim, (k, np.abs(got[k] - want[k]).max(), lim)


@pytest.mark.parametrize("k", [0.25, 1.0])
def test_sparse_anchor_boundaries_match_the_per_leaf_oracle(k):
    j, p, jstate, pstate = _mid_training(dict(name="sparse_anchor", sparse_k=k))
    oracle = jmake_strategy(JAlgo(name="sparse_anchor", sparse_k=k, packed=False))
    lay = jstate.x.layout
    xl = jpacking.unpack(jstate.x)
    jv = jstrategy.AlgoVars(z=jpacking.unpack(jstate.vars.z), extra=jpacking.unpack(jstate.vars.extra))
    ji = jpacking.unpack(jstate.inflight)
    px, pv, pi = pstate.x, pstate.vars, pstate.inflight
    for _ in range(3):
        xl, jv, ji = oracle.boundary_round(xl, jv, ji)
        px, pv, pi = p.strategy_obj.boundary_round(px, pv, pi)
    want = {"x": jpacking.pack(xl, layout=lay, lead=1), "z": jpacking.pack(jv.z, layout=jstate.vars.z.layout),
            "err": jpacking.pack(jv.extra, layout=jstate.vars.extra.layout),
            "inflight": jpacking.pack(ji, layout=jstate.inflight.layout)}
    want = {k2: np.asarray(v.buffers[0]) for k2, v in want.items()}
    got = {"x": px.buffers[0].numpy(), "z": pv.z.buffers[0].numpy(), "err": pv.extra.buffers[0].numpy(),
           "inflight": pi.buffers[0].numpy()}
    _within_ulps(want, got, 4, scale={"err": want["z"]})
    if k == 1.0:  # dense: nothing held back
        assert not got["err"].any()


def test_sparsify_tie_rule_matches_the_per_leaf_oracle():
    """Ties at the threshold are kept: with 40 of 100 magnitudes equal to
    the (1 − k) quantile the leaf sends 40 + 30 elements for k = 0.5; a
    one-element leaf is sent whole."""
    vals = np.concatenate([np.full(30, 0.5), np.full(40, 0.25), np.full(30, 0.125)]).astype(np.float32)
    vals *= np.where(np.arange(100) % 2, 1, -1).astype(np.float32)
    tree = {"a": np.random.default_rng(0).permutation(vals).reshape(10, 10), "b": np.asarray([1e-9], np.float32)}
    want = jstrategy.sparsify_topk(jax.tree.map(jnp.asarray, tree), 0.5)
    ptree = {k: torch.from_numpy(v.copy()) for k, v in tree.items()}
    plane = packing.pack(ptree)
    s = sparsify_topk_(plane.buffers[0].clone(), plane.layout, 0, 0.5)
    got = packing.unpack(packing.Packed((s,), plane.layout))
    for k in tree:
        assert np.array_equal(got[k].numpy(), np.asarray(want[k])), k
    assert int((got["a"] != 0).sum()) == 70 and got["b"].item() == np.float32(1e-9)


def test_quantile_of_a_leaf_past_2_24_elements_matches_jnp_quantile():
    """A leaf of 2^24 + 3 elements (a full-width qwen2-7b MLP leaf holds
    67.9M; ``torch.quantile`` stops at 2^24): the port's threshold equals
    ``jnp.quantile(..., method="linear")`` bit for bit, and the kept count
    is what that threshold keeps."""
    a = np.abs(np.random.default_rng(0).normal(size=(1 << 24) + 3).astype(np.float32))
    want = np.asarray(jnp.quantile(jnp.asarray(a), 0.75))
    t = torch.from_numpy(a)
    assert _quantile_linear(t, 0.75).numpy() == want
    layout = packing.layout_of({"w": t})
    s = sparsify_topk_(torch.from_numpy(np.pad(a, (0, layout.bucket_sizes[0] - a.size))), layout, 0, 0.25)
    assert int(torch.count_nonzero(s)) == int((a >= want).sum())


def test_delayed_avg_consumes_after_local_step_k():
    """delay 1, τ 2: the rebase happens after local step 0 and not after
    step 1, and the boundary only launches."""
    _, p, _, pstate = _mid_training(dict(name="delayed_avg", delay_steps=1))
    strat, x = p.strategy_obj, pstate.x
    before = x.buffers[0].clone()
    strat.local_post_update_packed(x, pstate.vars, pstate.inflight, 1)
    assert torch.equal(x.buffers[0], before)
    strat.local_post_update_packed(x, pstate.vars, pstate.inflight, 0)
    av, x0 = pstate.inflight.avg.buffers[0], pstate.inflight.x0.buffers[0]
    assert torch.equal(x.buffers[0], (av[None] + before - x0))
    after = x.buffers[0].clone()
    _, _, infl = strat.boundary_round(x, pstate.vars, pstate.inflight)
    assert torch.equal(x.buffers[0], after) and torch.equal(infl.x0.buffers[0], after)


def test_delayed_avg_with_delay_tau_is_cocod():
    runs = []
    for s in (dict(name="delayed_avg", delay_steps=2), dict(name="cocod")):
        exp = Experiment(task=ClassificationSpec(**SMALL), strategy=AlgoConfig(tau=2, **s), device="cpu")
        runs.append((exp.fit(rounds=5).losses, exp.state.x.buffers[0]))
    assert runs[0][0] == runs[1][0] and torch.equal(runs[0][1], runs[1][1])


@pytest.mark.parametrize("strategy", [dict(name="cocod"), dict(name="delayed_avg"), dict(name="gossip_ring")],
                         ids=lambda s: s["name"])
def test_inflight_planes_do_not_alias_x(strategy):
    """The reference may hand x itself over as the in-flight x0 / mix
    (immutable arrays); the port writes x in place, so each in-flight plane
    has its own storage, and a local step's write to x leaves the value the
    next boundary consumes unchanged."""
    _, p, _, pstate = _mid_training(strategy)
    strat = p.strategy_obj
    for state_x, inflight in ((pstate.x, pstate.inflight),
                              (pstate.x, strat.boundary_round(pstate.x, pstate.vars, pstate.inflight)[2])):
        plane = inflight.mix if hasattr(inflight, "mix") else inflight.x0
        for bx, bp in zip(state_x.buffers, plane.buffers):
            assert bx.untyped_storage().data_ptr() != bp.untyped_storage().data_ptr()
        kept = [b.clone() for b in plane.buffers]
        for bx in state_x.buffers:
            bx.add_(1.0)  # a local step's in-place write
        assert all(torch.equal(a, b) for a, b in zip(kept, plane.buffers))


# -- rounds and fits ------------------------------------------------------------------

ROUND_CASES = BOUNDARY_CASES + [dict(name="sparse_anchor", sparse_k=0.25), dict(name="powersgd")]


@pytest.mark.parametrize("strategy", ROUND_CASES, ids=lambda s: "-".join(str(v) for v in s.values()))
def test_one_round_from_mid_training_matches_jax(strategy):
    """The whole round: local steps with the mid-round hook (delayed_avg)
    or the gradient hook (powersgd), then the boundary."""
    j, p, jstate, pstate = _mid_training(strategy)
    rb = jloaders.round_batch(j.next_batch, j.tau)
    jstate, jms = j.step_fn(jstate, rb)
    pstate, pms = p.step_fn(pstate, p.to_device(tuple(np.asarray(a) for a in rb)))
    want, got = _slots(jstate), _slots(pstate)
    assert sorted(want) == sorted(got)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(pms["loss"].numpy(), np.asarray(jms["loss"]), rtol=1e-5)


FIT_CASES = [
    (dict(name="easgd"), 1e-4),
    (dict(name="cocod"), 1e-4),
    (dict(name="delayed_avg", delay_steps=1), 1e-4),
    (dict(name="sparse_anchor", sparse_k=0.25), 1e-3),
    (dict(name="powersgd"), 1e-4),
    (dict(name="gossip_full"), 1e-4),
    (dict(name="gossip_ring"), 1e-4),
    (dict(name="gossip_exp"), 1e-4),
    (dict(name="sgp", topology="ring"), 1e-4),
]


@pytest.mark.parametrize("strategy,rtol", FIT_CASES, ids=lambda s: "-".join(str(v) for v in s.values())
                         if isinstance(s, dict) else str(s))
def test_fit_losses_match_jax_over_20_rounds(strategy, rtol):
    j, p = _pair(strategy, workers=4)
    jl, pl = np.asarray(j.fit(rounds=20).losses), np.asarray(p.fit(rounds=20).losses)
    np.testing.assert_allclose(pl, jl, rtol=rtol)
    assert abs(p.evaluate()["test_acc"] - j.evaluate()["test_acc"]) <= 2 / SMALL["holdout"]


# -- the gossip boundary in one pass (K5's gossip form) ----------------------------------------

GOSSIP_N = 301  # columns: no vector width divides it, so every plan runs its scalar tail


def _gossip_inputs(m, dtype, masked, seed):
    """Seeded numpy planes for one gossip boundary over ``GOSSIP_N``
    columns: x, the consumed mix, its push weights (row 0 received no mass),
    the workers' weights, and a live mask (row m-1 dead when ``masked``).
    Push weights lie in [0.6, 1]: a ring's stay at 1, and at most 1 the
    push keeps |mix'| within the binade of max|x| that the bf16 bound names."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, GOSSIP_N)).astype(np.float32)
    mix = rng.normal(size=(m, GOSSIP_N)).astype(np.float32)
    wmix = rng.uniform(0.6, 1.0, m).astype(np.float32)
    wmix[0] = 0.0
    w = rng.uniform(0.6, 1.0, m).astype(np.float32)
    mask = np.ones(m, np.float32)
    if masked:
        mask[m - 1] = 0.0
    return x, mix, wmix, w, mask


@pytest.mark.parametrize("masked", [False, True], ids=["live", "dead_row"])
@pytest.mark.parametrize("topology", ["ring", "exp"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m", [2, 4, 16, 17])
def test_gossip_form_matches_jax_packed_boundary(m, dtype, topology, masked):
    """The port's gossip boundary (one ``gossip_boundary_`` a bucket, its
    plain version here) against ``GossipPushSumStrategy._packed_boundary``
    on the same planes, at phase 1 of the topology: x, the next mix, the
    workers' and the pushed weights. A row with no received mass, and with
    ``masked`` a row dead in the membership, keep x."""
    x, mix, wmix, w, mask = _gossip_inputs(m, dtype, masked, seed=100 * m + 7)
    tdt = getattr(torch, dtype)
    jlay = jpacking.layout_of({"w": jnp.zeros(GOSSIP_N, dtype)})
    jstrat = jmake_strategy(JAlgo(name="gossip_pushsum", topology=topology))
    jvars = jstrategy.AlgoVars(extra=(jnp.asarray(w), jnp.asarray(1, jnp.int32)))
    jinfl = jstrategy.GossipInflight(mix=JPacked((jnp.asarray(mix, dtype),), jlay), w=jnp.asarray(wmix))
    jmem = jmembership.from_mask(mask) if masked else None
    want = jstrat._packed_boundary(JPacked((jnp.asarray(x, dtype),), jlay), jvars, jinfl, membership=jmem)
    play = packing.layout_of({"w": torch.zeros(GOSSIP_N, dtype=tdt)})
    pstrat = make_strategy(AlgoConfig(name="gossip_pushsum", topology=topology))
    px = Packed((torch.from_numpy(x).to(tdt),), play)
    pvars = pstrategy.AlgoVars(extra=(torch.from_numpy(w), torch.tensor(1, dtype=torch.int32)))
    pinfl = pstrategy.GossipInflight(mix=Packed((torch.from_numpy(mix).to(tdt),), play), w=torch.from_numpy(wmix))
    pmem = pmembership.from_mask(mask) if masked else None
    got = pstrat.boundary_round(px, pvars, pinfl, membership=pmem)
    assert got[0] is px and got[2].mix.buffers[0] is pinfl.mix.buffers[0]  # in place
    want, got = _slots(want), _slots(got)
    assert sorted(want) == sorted(got)
    held = [0] + ([m - 1] if masked else [])
    np.testing.assert_array_equal(got["[0]0"][held], torch.from_numpy(x[held]).to(tdt).float().numpy())
    if dtype == "float32":
        _within_ulps(want, got, 4)
        return
    lim = np.ldexp(np.float32(1), np.frexp(np.abs(want["[0]0"]).max())[1] - 8)
    for k in want:
        assert np.abs(got[k] - want[k]).max() <= lim, (k, np.abs(got[k] - want[k]).max(), lim)


def test_gossip_boundary_makes_one_launch_a_bucket_and_reads_nothing_back(monkeypatch):
    """The boundary on the meta device (no data: a host read raises) with a
    stand-in for the gossip form: one call a bucket, each with the bucket's
    x and mix and the (m,)/(m, m) float32 operands, and none of the other
    wrappers."""
    m, meta = 5, torch.device("meta")
    params = {"a": torch.zeros(3, 70), "b": torch.zeros(40, dtype=torch.bfloat16)}
    lay = packing.layout_of(params)
    px = Packed(tuple(torch.empty(m, n, dtype=getattr(torch, d), device=meta)
                      for n, d in zip(lay.bucket_sizes, lay.bucket_dtypes)), lay)
    mix = Packed(tuple(torch.empty_like(b) for b in px.buffers), lay)
    calls = []

    def stand_in(x, mx, wsafe, live, peff, alpha):
        assert all(t.device == meta for t in (x, mx, wsafe, live, peff))
        assert (wsafe.shape, live.shape, peff.shape) == ((m,), (m,), (m, m))
        assert wsafe.dtype == live.dtype == peff.dtype == torch.float32
        calls.append((x, mx))
        return x, mx

    strat = make_strategy(AlgoConfig(name="gossip_ring"))
    vars_ = pstrategy.AlgoVars(extra=(torch.ones(m, device=meta), torch.zeros((), dtype=torch.int32, device=meta)))
    inflight = pstrategy.GossipInflight(mix=mix, w=torch.ones(m, device=meta))
    membership = pmembership.Membership(mask=torch.ones(m, device=meta), weights=torch.ones(m, device=meta))
    monkeypatch.setattr(am_ops, "gossip_boundary_", stand_in)
    for mem in (None, membership):
        calls.clear()
        out = strat.boundary_round(px, vars_, inflight, membership=mem)
        assert [(a is x, b is z) for (a, b), x, z in zip(calls, px.buffers, mix.buffers)] == [(True, True)] * 2
        assert len(calls) == lay.num_buckets == 2
        assert out[1].extra[0].device == meta and out[2].w.shape == (m,)


# -- the LM path: gossip_ring on the reduced qwen2-7b ----------------------------------------

LM_WORKERS, LM_BATCH, LM_SEQ, LM_LR = 4, 2, 64, 1e-2


def _lm_pair(dtype):
    jcfg = dataclasses.replace(jax_get_arch("qwen2-7b").model.reduced(), dtype=dtype)
    tcfg = dataclasses.replace(get_arch("qwen2-7b").model.reduced(), dtype=dtype)
    kw = dict(workers=LM_WORKERS, rounds=2)
    j = JExperiment(arch=jcfg, strategy=JAlgo(name="gossip_ring"), optimizer=JOpt(name="sgd", lr=LM_LR),
                    schedule=jsched.constant(LM_LR), data=JTokenStream(LM_BATCH, LM_SEQ), **kw).build()
    p = Experiment(arch=tcfg, strategy=AlgoConfig(name="gossip_ring"), optimizer=OptimizerConfig(name="sgd", lr=LM_LR),
                   schedule=schedules.constant(LM_LR), data=TokenStream(LM_BATCH, LM_SEQ), device="cpu", **kw).build()
    # round 1 on the reference; both packages then run round 2 from its state
    rb = jloaders.round_batch(jloaders.lm_batch_fn(jcfg, LM_WORKERS, LM_BATCH, LM_SEQ, seed=3), 2)
    jstate, _ = j.step_fn(j.state, rb)
    rb = jloaders.round_batch(jloaders.lm_batch_fn(jcfg, LM_WORKERS, LM_BATCH, LM_SEQ, seed=4), 2)
    jstate2, jms = j.step_fn(jstate, rb)
    pstate, pms = p.step_fn(_carry(jstate, p), p.to_device(_np(rb)))
    return _slots(jstate2), _slots(pstate), np.asarray(jms["loss"]), pms["loss"].numpy()


def test_lm_gossip_round_matches_jax():
    """f32: every slot rtol 1e-5, atol 1e-6 (as the overlap LM round in
    ``tests/test_torch_lm.py``), losses rtol 1e-6."""
    want, got, jl, pl = _lm_pair("float32")
    assert sorted(want) == sorted(got) and ".inflight.mix0" in got
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(pl, jl, rtol=1e-6)


def test_lm_gossip_round_bf16_matches_jax():
    """bf16, the bounds of the overlap bf16 LM round (ROADMAP Queue 3):
    x and the in-flight mix within one bf16 ulp of the plane's largest |x|,
    the momentum within 4 ulps of its own largest value, the push weights
    exactly, the losses rtol 1e-3."""
    want, got, jl, pl = _lm_pair("bfloat16")

    def ulps(a, n):
        return n * np.ldexp(np.float32(1), np.frexp(np.abs(a).max())[1] - 8)

    for k in want:
        if want[k].dtype.kind != "f" or k.startswith(".vars.extra"):
            assert np.array_equal(got[k], want[k]), k
            continue
        lim = ulps(want[k], 4) if ".momentum" in k else ulps(want[".x0"], 1)
        assert np.abs(got[k] - want[k]).max() <= lim, (k, np.abs(got[k] - want[k]).max(), lim)
    np.testing.assert_allclose(pl, jl, rtol=1e-3)

