"""The port's classifier training slice (repro_torch) against the JAX
reference, on the CPU.

Both packages get the same inputs: numpy data from one seed (the port's
data code is a numpy copy) and, where weights matter, the reference's
``Experiment.build()`` state carried over bit for bit by
``repro_torch.interop`` (``jax.random`` and ``torch.Generator`` draw
different weights). Stated tolerances and why:

* layouts, planes, batches, schedules: exact;
* one round from equal states (f32): rtol 1e-5, atol 1e-6 on every state
  plane — the matmuls, tanh and logsumexp of the two packages sum and round
  in other orders (observed ~1e-7);
* 20 rounds of fit (f32): per-round losses rtol 1e-4 (SGD: observed ~3e-7;
  AdamW ~2e-5, its 1/sqrt(nu) step amplifies the order differences), and
  test accuracy within 2 / holdout samples;
* one round in bf16: see ``test_one_round_bf16_matches_jax``.
"""
import dataclasses
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import ClassificationSpec as JSpec
from repro.api import Experiment as JExperiment
from repro.config import AlgoConfig as JAlgo
from repro.config import OptimizerConfig as JOpt
from repro.config import get_arch as jax_get_arch
from repro.data import loaders as jloaders
from repro.models import classifier as jclf
from repro.models import transformer as JT
from repro.optim import from_config as jopt_from_config
from repro.optim import schedules as jsched
from repro.core import make_strategy as jmake_strategy
from repro.parallel import packing as jpacking
from repro.training import make_round_step as jmake_round_step
from repro.training import make_train_state as jmake_train_state
from repro_torch import interop
from repro_torch.api import ClassificationSpec, Experiment
from repro_torch.config import AlgoConfig, MoEConfig, OptimizerConfig, get_arch
from repro_torch.core import make_strategy
from repro_torch.data import loaders
from repro_torch.models import classifier as clf
from repro_torch.models import transformer as T
from repro_torch.optim import from_config as opt_from_config
from repro_torch.optim import schedules
from repro_torch.parallel import packing
from repro_torch.training import make_round_step, make_train_state

SRC = Path(__file__).resolve().parents[1] / "src"
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


def _pair(strategy=None, optimizer="sgd", workers=4, **kw):
    """A JAX experiment and a port experiment of one configuration, the port
    starting from the JAX experiment's built state."""
    strategy = strategy or {}
    j = JExperiment(task=JSpec(**SMALL), strategy=JAlgo(**strategy), optimizer=JOpt(name=optimizer),
                    workers=workers, **kw).build()
    p = Experiment(task=ClassificationSpec(**SMALL), strategy=AlgoConfig(**strategy),
                   optimizer=OptimizerConfig(name=optimizer), workers=workers, device="cpu", **kw).build()
    p.state = interop.state_from_numpy(_np(j.state), packing.layout_of(p.params))
    return j, p


def _planes(state):
    """Every plane of a (JAX or port) state, as float32 numpy, by name."""
    out = {}

    def add(name, p):
        if p is not None:
            for i, b in enumerate(p.buffers):
                out[f"{name}{i}"] = np.asarray(b.float() if isinstance(b, torch.Tensor) else b.astype(jnp.float32))

    add("x", state.x)
    for f in state.opt._fields:
        v = getattr(state.opt, f)
        if f == "count":
            out["count"] = np.asarray(v)
        else:
            add(f, v)
    add("z", state.vars.z)
    add("v", state.vars.v)
    add("inflight", state.inflight)
    out["step"] = np.asarray(state.step)
    return out


# -- packing ---------------------------------------------------------------------


def _slots(layout):
    return [(s.index, s.bucket, tuple(s.shape), s.dtype, s.offset, s.size, s.stride) for s in layout.slots]


def _same_layout(jl, tl):
    assert _slots(jl) == _slots(tl)
    assert tuple(jl.bucket_dtypes) == tl.bucket_dtypes and tuple(jl.bucket_sizes) == tl.bucket_sizes


def test_layout_matches_jax_for_the_mlp():
    jparams, _ = jclf.init_mlp(jax.random.PRNGKey(0), 64, 10)
    tparams = clf.init_mlp(torch.Generator().manual_seed(0), 64, 10)
    tl = packing.layout_of(tparams)
    _same_layout(jpacking.layout_of(jparams), tl)
    # b0, b1, b_out, w0, w1, w_out, each padded to 128
    assert [p[0] for p in tl.paths] == ["b0", "b1", "b_out", "w0", "w1", "w_out"]
    assert tl.bucket_sizes == (128 + 128 + 128 + 8192 + 8192 + 640,)


def test_layout_matches_jax_for_reduced_qwen2():
    jparams, _ = JT.init_model(jax_get_arch("qwen2-7b").model.reduced(), jax.random.PRNGKey(0))
    tparams = T.init_model(get_arch("qwen2-7b").model.reduced(), torch.Generator().manual_seed(0))
    _same_layout(jpacking.layout_of(jparams), packing.layout_of(tparams))
    # stacked worker axis and a bf16 bucket beside the f32 one
    mixed = dict(tparams, tok_emb=tparams["tok_emb"].bfloat16())
    jmixed = dict(jparams, tok_emb=jparams["tok_emb"].astype(jnp.bfloat16))
    stacked = jax.tree.map(lambda t: jnp.stack([t, t]), jmixed)
    tstacked = {k: v for k, v in packing.tree_unflatten(
        packing.layout_of(mixed).paths, [torch.stack([t, t]) for t in packing.tree_flatten(mixed)[0]]).items()}
    _same_layout(jpacking.layout_of(stacked, lead=1), packing.layout_of(tstacked, lead=1))


def test_pack_unpack_round_trip_and_interop_bitwise(rng):
    tree = {"a": rng.normal(size=(3, 5)).astype(np.float32), "c": {"d": rng.normal(size=(7,)).astype(np.float32)},
            "b": rng.normal(size=(2, 130)).astype(np.float32)}
    jp = jpacking.pack(jax.tree.map(jnp.asarray, tree))
    tt = {"a": torch.from_numpy(tree["a"]), "b": torch.from_numpy(tree["b"]), "c": {"d": torch.from_numpy(tree["c"]["d"])}}
    tp = packing.pack(tt)
    assert torch.equal(tp.buffers[0], torch.from_numpy(np.array(jp.buffers[0])))
    carried = interop.packed_from_numpy(_np(jp), tp.layout)
    assert torch.equal(carried.buffers[0], tp.buffers[0])
    back = packing.unpack(tp)
    assert torch.equal(back["a"], tt["a"]) and torch.equal(back["c"]["d"], tt["c"]["d"])
    # unpack and view_leaf are views of the plane; padding is zero
    back["a"][0, 0] = 42.0
    assert tp.buffers[0][0] == 42.0
    slot = tp.layout.slots[0]
    assert torch.count_nonzero(tp.buffers[0][slot.offset + slot.size : slot.offset + slot.stride]) == 0
    # lead dims
    lead = packing.pack({"a": torch.ones(4, 3)}, lead=1)
    assert lead.lead_shape == (4,) and lead.buffers[0].shape == (4, 128)
    assert packing.packed_like(lead, 0.0, dtype=torch.bfloat16).layout.bucket_dtypes == ("bfloat16",)


def test_interop_rejects_a_different_layout():
    jp = jpacking.pack({"a": jnp.ones((3, 5))})
    with pytest.raises(ValueError, match="layout"):
        interop.packed_from_numpy(_np(jp), packing.layout_of({"a": torch.ones(3, 6)}))


# -- data and schedules -----------------------------------------------------------


@pytest.mark.parametrize("noniid", [False, True])
def test_batches_byte_identical_to_jax(noniid):
    kw = dict(n=2000, holdout=500, noniid=noniid, seed=3)
    js = jloaders.make_classification_splits(4, **kw)
    ts = loaders.make_classification_splits(4, **kw)
    for a, b in zip(js.parts, ts.parts):
        assert np.array_equal(a, b)
    jb, tb = jloaders.classification_batch_fn(js, 32, seed=3), loaders.classification_batch_fn(ts, 32, seed=3)
    for _ in range(10):
        for a, b in zip(jb(), tb()):
            a = np.asarray(a)
            assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()
    rb = loaders.round_batch(tb, 2)
    assert rb[0].shape == (2, 4, 32, 64) and rb[1].shape == (2, 4, 32)


@pytest.mark.parametrize(
    "make,atol",
    [
        (lambda s: s.warmup_step_decay(0.1, 20, (150, 300)), 0.0),
        (lambda s: s.warmup_step_decay(0.3, 7, ()), 0.0),
        (lambda s: s.constant(0.05), 0.0),
        (lambda s: s.from_config(OptimizerConfig(lr=0.2, warmup_steps=5, decay_steps=(100,))), 0.0),
        # XLA's and PyTorch's f32 cos differ in the last bit; near cos = -1 the
        # 1 + cos cancels, so allow one f32 ulp of cos carried through base_lr
        (lambda s: s.cosine(0.1, 10, 400), 0.1 * 2.0**-23),
    ],
)
def test_schedules_equal_jax_in_f32(make, atol):
    steps = np.arange(401, dtype=np.int32)
    want = np.asarray(jax.vmap(make(jsched))(jnp.asarray(steps)))
    fn = make(schedules)
    got = np.asarray([fn(torch.tensor(int(s), dtype=torch.int32)).item() for s in steps], np.float32)
    assert got.dtype == want.dtype and np.abs(got - want).max() <= atol
    assert np.array_equal(np.broadcast_to(fn(torch.arange(401, dtype=torch.int32)).numpy(), got.shape), got)


# -- training --------------------------------------------------------------------


def test_config_copies_match_reference():
    assert dataclasses.asdict(AlgoConfig()) == dataclasses.asdict(JAlgo())
    assert dataclasses.asdict(OptimizerConfig()) == dataclasses.asdict(JOpt())


@pytest.mark.parametrize("strategy", [{}, {"anchor_beta": 0.0}, {"name": "local_sgd"}, {"name": "sync_sgd"}])
def test_one_round_state_matches_jax(strategy):
    j, p = _pair(strategy)
    tau = j.tau
    rb = jloaders.round_batch(j.next_batch, tau)
    jstate, jms = j.step_fn(j.state, rb)
    pstate, pms = p.step_fn(p.state, p.to_device(tuple(np.asarray(a) for a in rb)))
    want, got = _planes(jstate), _planes(pstate)
    assert sorted(want) == sorted(got)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(pms["loss"].numpy(), np.asarray(jms["loss"]), rtol=1e-5)
    np.testing.assert_array_equal(pms["lr"].numpy(), np.asarray(jms["lr"]))


def test_boundary_keeps_the_consumed_anchor():
    """K3's new anchor gets its own buffer: after a round ``vars.z`` is the
    anchor the boundary consumed (the old inflight), and the new inflight is
    a different tensor, as the reference's ``vars.z = inflight``."""
    _, p = _pair()
    before = p.state.inflight
    z_before = [b.clone() for b in before.buffers]
    p.fit(rounds=1)
    assert p.state.vars.z is before and p.anchor_plane() is before
    assert all(torch.equal(a, b) for a, b in zip(z_before, p.state.vars.z.buffers))
    assert all(a.data_ptr() != b.data_ptr() for a, b in zip(p.state.inflight.buffers, before.buffers))


FIT_CASES = [
    ({}, "sgd"),  # K1 + K3
    ({"anchor_beta": 0.0}, "sgd"),  # K4
    ({"name": "local_sgd"}, "sgd"),
    ({"name": "sync_sgd"}, "sgd"),
    ({}, "adamw"),  # K2
]


@pytest.mark.parametrize("strategy,optimizer", FIT_CASES)
def test_fit_losses_match_jax_over_20_rounds(strategy, optimizer):
    j, p = _pair(strategy, optimizer)
    jl, pl = np.asarray(j.fit(rounds=20).losses), np.asarray(p.fit(rounds=20).losses)
    np.testing.assert_allclose(pl, jl, rtol=1e-4)
    assert abs(p.evaluate()["test_acc"] - j.evaluate()["test_acc"]) <= 2 / SMALL["holdout"]
    cj = j.consensus()
    for k, v in p.consensus().items():
        np.testing.assert_allclose(v.numpy(), np.asarray(cj[k]), rtol=1e-3, atol=1e-4)
    jp, tp = j.consensus_plane(), p.consensus_plane()
    np.testing.assert_allclose(tp.buffers[0].numpy(), np.asarray(jp.buffers[0]), rtol=1e-3, atol=1e-4)


def test_grad_clip_and_microbatch_match_jax():
    """Per-worker global-norm clipping on the plane and f32 gradient
    accumulation over microbatches, one round against the reference."""
    for kw in (dict(grad_clip=0.5), dict(microbatch=8), dict(grad_clip=0.5, microbatch=16)):
        j, p = _pair(**kw)
        rb = jloaders.round_batch(j.next_batch, j.tau)
        jstate, jms = j.step_fn(j.state, rb)
        pstate, pms = p.step_fn(p.state, p.to_device(tuple(np.asarray(a) for a in rb)))
        want, got = _planes(jstate), _planes(pstate)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6, err_msg=f"{kw} {k}")
        np.testing.assert_allclose(pms["loss"].numpy(), np.asarray(jms["loss"]), rtol=1e-5)


def test_one_round_bf16_matches_jax():
    """bf16 parameters through both packages' public functions (the MLP then
    runs in f32 with bf16 weights, as jnp promotes). Bound: every plane
    within 2 bf16 ulps of its scale — the parameter plane's largest |x| for
    x, z, v and the in-flight anchor, the momentum's own largest value for
    the momentum. Why: the two packages' f32 gradients differ in their last
    bits (sums in other orders), so their bf16 roundings differ by an ulp
    here and there (observed in ~3% of x); an update or anchor difference
    that cancels (v = mean − z, momentum = 0.9·g1 + g2) keeps the ulp of its
    operands, not of its small result."""
    m, spec = 4, JSpec(**SMALL)
    jparams, _ = jclf.init_mlp(jax.random.PRNGKey(0), spec.dim, spec.num_classes, dtype=jnp.bfloat16)
    jstrat, jopt = jmake_strategy(JAlgo()), jopt_from_config(JOpt())
    jstate = jmake_train_state(jparams, m, jopt, jstrat)
    jstep = jax.jit(jmake_round_step(jclf.mlp_loss, jopt, jstrat, jsched.constant(0.1)))
    tparams = clf.init_mlp(torch.Generator().manual_seed(0), spec.dim, spec.num_classes, dtype=torch.bfloat16)
    assert all(t.dtype == torch.bfloat16 for t in tparams.values())
    tstrat, topt = make_strategy(AlgoConfig()), opt_from_config(OptimizerConfig())
    tstate = interop.state_from_numpy(_np(jstate), packing.layout_of(tparams))
    assert tstate.x.buffers[0].dtype == torch.bfloat16
    tstep = make_round_step(clf.mlp_loss, topt, tstrat, schedules.constant(0.1))
    splits = jloaders.make_classification_splits(m, **SMALL)
    rb = jloaders.round_batch(jloaders.classification_batch_fn(splits, 32), 2)
    jstate, _ = jstep(jstate, rb)
    tstate, _ = tstep(tstate, tuple(torch.from_numpy(np.array(a)) for a in rb))
    want, got = _planes(jstate), _planes(tstate)

    def two_ulps(a):
        return 2 * np.ldexp(np.float32(1), np.frexp(np.abs(a).max())[1] - 8)

    x_scale = two_ulps(want["x0"])
    for k in want:
        lim = two_ulps(want[k]) if k.startswith("momentum") else x_scale
        if k == "step":
            lim = 0
        assert np.abs(got[k] - want[k]).max() <= lim, (k, np.abs(got[k] - want[k]).max(), lim)


def test_make_train_state_starts_workers_equal():
    params = clf.init_mlp(torch.Generator().manual_seed(1), 8, 3, hidden=(4,))
    strat = make_strategy(AlgoConfig())
    state = make_train_state(params, 3, opt_from_config(OptimizerConfig(name="adamw")), strat)
    b = state.x.buffers[0]
    assert b.shape == (3, packing.layout_of(params).bucket_sizes[0])
    assert all(torch.equal(b[0], b[i]) for i in range(3))
    assert torch.equal(state.inflight.buffers[0], b[0]) and torch.equal(state.vars.z.buffers[0], b[0])
    assert state.inflight.buffers[0].data_ptr() != state.vars.z.buffers[0].data_ptr()
    assert state.opt.mu.buffers[0].dtype == torch.float32 and int(state.opt.count) == 0


# -- entry points ------------------------------------------------------------------


def test_experiment_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the CUDA default does not raise here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Experiment(task=ClassificationSpec(**SMALL)).build()


def test_unported_paths_raise_with_their_roadmap_item():
    """What still raises, each naming its ROADMAP item: the MoE archs (8),
    host offload (9), the per-leaf oracle (4b), the checkpointer (6b) and
    the runtime model behind ``FaultPlan.runtime_config`` (10). The probe and
    the membership of every boundary, ``fit(adaptive_tau=...)`` and
    ``fit(faults=...)`` are ported and run."""
    from repro_torch.fault import FaultPlan, from_mask
    from repro_torch.launch import train as train_cli

    moe = dataclasses.replace(get_arch("qwen2-7b").model.reduced(), layer_pattern=("moe", "moe"),
                              moe=MoEConfig(num_experts=4, top_k=2, expert_ff=64))
    with pytest.raises(NotImplementedError, match="item 8"):
        Experiment(arch=moe, device="cpu").build()
    with pytest.raises(NotImplementedError, match="item 9"):
        make_strategy(AlgoConfig(offload=True))
    with pytest.raises(NotImplementedError, match="item 6b"):
        train_cli.main(["--arch", "qwen2-7b", "--device", "cpu", "--ckpt", "x.npz"])
    with pytest.raises(NotImplementedError, match="item 10"):
        FaultPlan(m=2).runtime_config()
    for name in ("overlap_local_sgd", "easgd", "delayed_avg", "gossip_ring", "loscar"):
        with pytest.raises(NotImplementedError, match="item 4b"):
            make_strategy(AlgoConfig(name=name, packed=False))
        strat = make_strategy(AlgoConfig(name=name))
        px = packing.pack({"w": torch.arange(6.0).reshape(2, 3)}, lead=1)
        vars = strat.init_vars(px)
        out = strat.boundary_round(px, vars, strat.init_inflight(px, vars), probe=True,
                                   membership=from_mask(np.ones(2, np.float32)))
        assert len(out) == 4 and torch.isfinite(out[3].drift) and torch.isfinite(out[3].scale)
    exp = Experiment(task=ClassificationSpec(**SMALL), workers=2, device="cpu")
    from repro_torch.control import TauController

    res = exp.fit(rounds=2, adaptive_tau=TauController(), faults=FaultPlan(m=2, crashes=((1, 1, None),)))
    assert [h["decision"] for h in res.tau_schedule][1] == "fault_hold" and len(res.fault_log) == 1
    with pytest.raises(ValueError, match="unknown strategy"):
        make_strategy(AlgoConfig(name="nope"))
    with pytest.raises(ValueError, match="anchor_plane"):
        Experiment(task=ClassificationSpec(**SMALL), strategy="local_sgd", device="cpu").anchor_plane()


def test_experiment_introspection_and_steps():
    exp = Experiment(task=ClassificationSpec(**SMALL), strategy="sync_sgd", workers=2, device="cpu")
    assert exp.tau == 1 and exp.num_params == 64 * 128 + 128 + 128 * 64 + 64 + 64 * 10 + 10
    res = exp.fit(steps=3)
    assert res.rounds == 3 and res.steps == 3 and len(res.losses) == 3
    assert int(exp.state.step) == 3
    assert 0.0 <= exp.evaluate()["test_acc"] <= 1.0


def test_training_modules_import_no_jax():
    code = textwrap.dedent(
        f"""
        import sys
        sys.path.insert(0, {str(SRC)!r})
        sys.modules["jax"] = None
        from repro_torch.api import ClassificationSpec, Experiment, TokenStream
        from repro_torch.control import TauController
        from repro_torch.core import powersgd, topology
        from repro_torch.fault import FaultPlan
        from repro_torch.launch import train
        exp = Experiment(task=ClassificationSpec(n=600, holdout=100), workers=2, device="cpu")
        print(len(exp.fit(rounds=2).losses))
        res = exp.fit(rounds=2, adaptive_tau=TauController(), faults=FaultPlan.parse("crash:1@1", m=2))
        print(len(res.tau_schedule))
        for name in ("gossip_ring", "powersgd", "sparse_anchor", "delayed_avg"):
            exp = Experiment(task=ClassificationSpec(n=600, holdout=100), strategy=name, workers=4, device="cpu")
            print(len(exp.fit(rounds=2).losses))
        lm = Experiment(arch="qwen2-7b", workers=2, data=TokenStream(1, 16), device="cpu")
        print(len(lm.fit(rounds=1).losses))
        bad = sorted(m for m in sys.modules if m == "repro" or m.startswith("repro."))
        assert not bad, bad
        """
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["2", "2", "2", "2", "2", "2", "1"]
