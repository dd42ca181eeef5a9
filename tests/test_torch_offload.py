"""Host offload in the port (``repro_torch.parallel.offload``, the optimizers'
``step_streamed``, ``AlgoConfig.offload`` through the round engine) against
the JAX reference's ``repro.parallel.offload``, on the CPU.

Both packages get the same inputs: the parameter tree and the batches are
made from one numpy seed (the reference's ``tests/test_offload.py`` tree,
whose buckets span several 512-byte chunks at ``offload_chunk_mb`` 1/2048;
its least-squares loss over the flattened leaves, with the data scaled by
1/√n so that lr 0.03 converges). Stated bounds and why:

* the chunk grid, the chunk stacks and the round trips: exact;
* the streamed step against the resident one, and offloaded rounds against
  resident rounds of the port: bitwise in every plane (the update is
  elementwise, the copies exact);
* the port's offloaded rounds against the reference's offloaded rounds
  (2 rounds of τ 3): f32 SGD rtol 1e-5, atol 1e-6 on every plane, as
  ``tests/test_torch_training.py`` holds one resident round (the two
  packages sum the loss's products in other orders); AdamW at the
  reference's own rtol 2e-4, atol 1e-6 (its 1/√ν step amplifies those
  order differences); bf16 within 2 bf16 ulps of a scale, as
  ``test_one_round_bf16_matches_jax``: the largest |x| for x, z, v and the
  in-flight plane, each optimizer plane's own largest value for it (the
  AdamW moments too: an f32 gradient a few ulps off rounds to a
  neighbouring bf16 value here and there, and the moments take it in);
* the faulted classifier run: the offloaded losses equal the resident ones
  exactly, and the reference's within rtol 1e-4 (the fit bound of
  ``tests/test_torch_training.py``);
* checkpoints: bitwise both ways.

The JAX modules are imported inside the ``jx`` fixture, so that the
``cuda`` tests (K1/K2's window form against the plain version and the
whole-plane launch) run where JAX is not installed, as on the card.
"""
import dataclasses
import importlib
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch import checkpoint, interop
from repro_torch.api import ClassificationSpec, Experiment
from repro_torch.config import AlgoConfig
from repro_torch.core import make_strategy
from repro_torch.kernels.opt_step import ops as opt_ops
from repro_torch.kernels.opt_step import ref as opt_ref
from repro_torch.optim import adamw, offload_capable, schedules, sgd
from repro_torch.parallel import offload as off
from repro_torch.parallel import packing
from repro_torch.training import make_round_step, make_train_state

M = 4
CHUNK_MB = 1 / 2048  # 512-byte chunks: 128 f32 or 256 bf16 elements
SMALL = dict(n=2000, holdout=500)
STRATEGY_VARIANTS = [
    ("overlap_local_sgd", dict(anchor_beta=0.7)),
    ("local_sgd", {}),
    ("delayed_avg", dict(delay_steps=2)),  # consumed mid-round (delay < τ)
    ("delayed_avg", dict(delay_steps=3)),  # consumed at the boundary (delay = τ)
]
OPT_KW = {"sgd": dict(momentum=0.9, nesterov=True, weight_decay=1e-4),
          "adamw": dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=1e-4)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small CPU ops: torch's thread pool only contends with XLA's here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jx():
    """The JAX reference (imported here, not at the top: see the module
    docstring)."""
    pytest.importorskip("jax")
    mod = importlib.import_module
    jax, jnp = mod("jax"), mod("jax.numpy")

    def loss(params, batch):  # tests/test_offload.py's loss
        A, b = batch
        flat = jnp.concatenate([jnp.ravel(l).astype(jnp.float32) for l in jax.tree.leaves(params)])
        r = A @ flat - b
        out = 0.5 * jnp.sum(r * r)
        return out, dict(loss=out)

    return SimpleNamespace(
        jax=jax, jnp=jnp, loss=loss, off=mod("repro.parallel.offload"), packing=mod("repro.parallel.packing"),
        config=mod("repro.config"), core=mod("repro.core"), optim=mod("repro.optim"),
        schedules=mod("repro.optim.schedules"), training=mod("repro.training"), ckpt=mod("repro.checkpoint"),
        api=mod("repro.api"), fault=mod("repro.fault.plan"),
    )


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc")
    return torch.device("cuda", 0)


# -- inputs ------------------------------------------------------------------------


def _params_np(rng, bf16: bool) -> dict:
    """The reference's mixed tree: bf16 adds a second bucket."""
    return {"w0": (rng.normal(size=(9, 33)), bf16), "w1": (rng.normal(size=(7, 41)), bf16),
            "vec": (rng.normal(size=(143,)), False), "scalar": (np.asarray(rng.normal()), False),
            "b0": (rng.normal(size=(37,)), bf16)}


def _jparams(jx, spec):
    jnp = jx.jnp
    return {k: jnp.asarray(a.astype(np.float32), jnp.bfloat16 if b else jnp.float32) for k, (a, b) in spec.items()}


def _tparams(spec):
    return {k: torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16 if b else torch.float32)
            for k, (a, b) in spec.items()}


def _tloss(params, batch):
    """The reference's loss, worker-stacked: (m,) losses."""
    A, b = batch
    leaves, _ = packing.tree_flatten(params)
    flat = torch.cat([l.reshape(A.shape[0], -1).float() for l in leaves], dim=1)
    r = torch.einsum("wbn,wn->wb", A, flat) - b
    losses = 0.5 * torch.sum(r * r, dim=1)
    return losses, dict(loss=losses)


def _batches(spec, tau, rounds, seed=1):
    n_flat = sum(max(a.size, 1) for a, _ in spec.values())
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(rounds):
        A = (rng.normal(size=(tau, M, 4, n_flat)) / np.sqrt(n_flat)).astype(np.float32)
        out.append((A, rng.normal(size=(tau, M, 4)).astype(np.float32)))
    return out


def _topt(name):
    return sgd(**OPT_KW[name]) if name == "sgd" else adamw(**OPT_KW[name])


def _cfg(name, kw, offload, tau=3):
    return dict(name=name, tau=tau, alpha=0.6, packed=True, offload=offload, offload_chunk_mb=CHUNK_MB, **kw)


def _port_run(spec, name, kw, opt_name, offload, rounds=2):
    strat = make_strategy(AlgoConfig(**_cfg(name, kw, offload)))
    opt = _topt(opt_name)
    state = make_train_state(_tparams(spec), M, opt, strat)
    step = make_round_step(_tloss, opt, strat, schedules.constant(0.03))
    for A, b in _batches(spec, strat.tau, rounds):
        state, _ = step(state, (torch.from_numpy(A), torch.from_numpy(b)))
    return state


def _jax_run(jx, spec, name, kw, opt_name, offload, rounds=2):
    strat = jx.core.make_strategy(jx.config.AlgoConfig(**_cfg(name, kw, offload)))
    opt = getattr(jx.optim, opt_name)(**OPT_KW[opt_name])
    state = jx.training.make_train_state(_jparams(jx, spec), M, opt, strat, None)
    step = jx.jax.jit(jx.training.make_round_step(jx.loss, opt, strat, jx.schedules.constant(0.03), None))
    for A, b in _batches(spec, strat.tau, rounds):
        state = step(state, (jx.jnp.asarray(A), jx.jnp.asarray(b)))[0]
    return state


def _planes(tree, name="", out=None):
    """Every array of a resident (JAX or port) state tree by name, as
    tensors (port) or numpy arrays (JAX)."""
    out = {} if out is None else out
    if tree is None:
        return out
    if hasattr(tree, "buffers") and hasattr(tree, "layout"):
        for i, b in enumerate(tree.buffers):
            out[f"{name}{i}"] = b
    elif hasattr(tree, "_fields"):
        for f in tree._fields:
            _planes(getattr(tree, f), f"{name}.{f}", out)
    elif isinstance(tree, (tuple, list)):
        for i, a in enumerate(tree):
            _planes(a, f"{name}[{i}]", out)
    else:
        out[name] = tree
    return out


def _f32(a) -> np.ndarray:
    return a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a).astype(np.float32)


def _two_bf16_ulps(a: np.ndarray) -> float:
    return float(2 * np.ldexp(np.float32(1), np.frexp(np.abs(a).max())[1] - 8)) if a.size else 0.0


# -- the chunk grid and the round trips --------------------------------------------


@pytest.mark.parametrize("chunk_mb", [CHUNK_MB, 1 / 256, off.DEFAULT_CHUNK_MB])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_offload_plan_matches_reference(jx, rng, bf16, chunk_mb):
    spec = _params_np(rng, bf16)
    jlay = jx.packing.layout_of(_jparams(jx, spec))
    tlay = packing.layout_of(_tparams(spec))
    want = jx.off.OffloadPlan.for_layout(jlay, chunk_mb)
    got = off.OffloadPlan.for_layout(tlay, chunk_mb)
    assert got.chunk_elems == tuple(want.chunk_elems) and got.num_chunks == tuple(want.num_chunks)
    for b in range(tlay.num_buckets):
        k, c = got.grid(b)
        assert c % packing.LANE == 0 and k == -(-tlay.bucket_sizes[b] // c)
        assert (k > 1) if chunk_mb == CHUNK_MB else True
    if chunk_mb == off.DEFAULT_CHUNK_MB:  # the default swallows these small buckets whole
        assert all(k == 1 for k in got.num_chunks)


@pytest.mark.parametrize("n,c", [(1, 128), (128, 128), (129, 128), (765, 128), (765, 256), (300, 512)])
def test_chunk_roundtrip_exact_and_equal_to_reference(jx, rng, n, c):
    for lead in ((), (M,)):
        a = rng.normal(size=lead + (n,)).astype(np.float32)
        k = -(-n // c)
        ch = off.chunk_buffer(torch.from_numpy(a), k, c)
        assert tuple(ch.shape) == (k,) + lead + (c,)
        np.testing.assert_array_equal(ch.numpy(), np.asarray(jx.off.chunk_buffer(jx.jnp.asarray(a), k, c)))
        np.testing.assert_array_equal(off.unchunk_buffer(ch, n).numpy(), a)


@pytest.mark.parametrize("opt_name", sorted(OPT_KW))
def test_tree_offload_restore_roundtrip_and_stacks_equal_reference(jx, rng, opt_name):
    spec = _params_np(rng, True)
    tx = packing.pack({k: t.expand(M, *t.shape) for k, t in _tparams(spec).items()}, lead=1)
    jx_tree = jx.jax.tree.map(lambda t: jx.jnp.tile(t[None], (M,) + (1,) * t.ndim), _jparams(jx, spec))
    jpx = jx.packing.pack(jx_tree, lead=1)
    # a state with non-zero planes: the momentum (or mu, nu) set from x
    tst = _topt(opt_name).init_packed(tx)
    jst = getattr(jx.optim, opt_name)(**OPT_KW[opt_name]).init_packed(jpx)
    jplanes = [getattr(jst, f) for f in jst._fields if f != "count"]
    tplanes = [getattr(tst, f) for f in tst._fields if f != "count"]
    for i, (tp, jp_) in enumerate(zip(tplanes, jplanes)):
        for tb, xb in zip(tp.buffers, tx.buffers):
            tb.copy_((xb.float() * (i + 2)).to(tb.dtype))
    jst = jst._replace(**{f: jx.packing.Packed(tuple(jx.jnp.asarray(b.float().numpy()).astype(jb.dtype)
                                                     for b, jb in zip(tp.buffers, jp_.buffers)), jp_.layout)
                          for f, tp, jp_ in zip([f for f in jst._fields if f != "count"], tplanes, jplanes)})
    plan = off.OffloadPlan.for_layout(tx.layout, CHUNK_MB)
    host = off.tree_offload(tst, plan)
    jhost = jx.off.tree_offload(jst, jx.off.OffloadPlan.for_layout(jpx.layout, CHUNK_MB))
    assert off.is_offloaded(host) and not off.is_offloaded(tst)
    assert off.plan_of(host) == plan and off.plan_of(tst) is None
    assert off.host_nbytes(host) == jx.off.host_nbytes(jhost) > 0
    assert off.stream_roundtrip_bytes(host) == jx.off.stream_roundtrip_bytes(jhost)
    n_planes = len(tplanes)
    assert off.staging_bytes(plan, tx.layout, n_planes) == jx.off.staging_bytes(
        jx.off.OffloadPlan.for_layout(jpx.layout, CHUNK_MB), jpx.layout, n_planes)
    for f in (f for f in tst._fields if f != "count"):
        for a, b in zip(getattr(host, f).chunks, getattr(jhost, f).chunks):
            np.testing.assert_array_equal(_f32(a), _f32(b))
    back = off.tree_restore(host)
    for a, b in zip(_planes(tst).values(), _planes(back).values()):
        assert torch.equal(a, b)
    if opt_name == "adamw":  # the count stays on the device, as it was
        assert host.count is tst.count


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("opt_name", sorted(OPT_KW))
def test_streamed_step_matches_packed_bitwise(rng, opt_name, bf16):
    """One streamed step (chunk by chunk through the two staging chunks,
    K1/K2's window form on each) equals the resident step bit for bit."""
    spec = _params_np(rng, bf16)
    opt = _topt(opt_name)
    px = packing.pack({k: t.expand(M, *t.shape) for k, t in _tparams(spec).items()}, lead=1)
    pg = packing.Packed(tuple((b.float() * 0.01 + 0.003).to(b.dtype) for b in px.buffers), px.layout)
    lr = torch.tensor(0.05)
    plan = off.OffloadPlan.for_layout(px.layout, CHUNK_MB)
    st = opt.init_packed(px)
    x_res = packing.Packed(tuple(b.clone() for b in px.buffers), px.layout)
    host = off.tree_offload(st, plan)
    for _ in range(2):
        st, x_res = opt.step_packed(st, x_res, pg, lr)
        host, px = opt.step_streamed(host, px, pg, lr)
    assert off.is_offloaded(host)
    for a, b in zip(px.buffers, x_res.buffers):
        assert torch.equal(a, b)
    for a, b in zip(_planes(off.tree_restore(host)).values(), _planes(st).values()):
        assert torch.equal(a, b)


# -- whole rounds ------------------------------------------------------------------


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("opt_name", sorted(OPT_KW))
@pytest.mark.parametrize("name,kw", STRATEGY_VARIANTS, ids=[f"{n}-{v}" for n, v in STRATEGY_VARIANTS])
def test_offloaded_rounds_equal_resident_and_agree_with_reference(jx, rng, name, kw, opt_name, bf16):
    """Two offloaded rounds (the state built offloaded, vars restored at the
    round's start, the inflight plane at the boundary or before the window,
    both sent back after it) equal two resident rounds of the port bit for
    bit in x, the optimizer state, z, v, extra and the inflight plane, and
    agree with the reference's offloaded rounds within the stated bounds."""
    spec = _params_np(rng, bf16)
    s_off = _port_run(spec, name, kw, opt_name, offload=True)
    s_res = _port_run(spec, name, kw, opt_name, offload=False)
    assert off.is_offloaded(s_off.opt) and not off.is_offloaded(s_res.opt)
    assert isinstance(s_off.x, packing.Packed)
    if s_off.inflight is not None:
        assert off.is_offloaded(s_off.inflight)
    got = _planes(off.tree_restore(s_off._replace(membership=None)))
    want = _planes(s_res._replace(membership=None))
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k

    j_off = _jax_run(jx, spec, name, kw, opt_name, offload=True)
    assert jx.off.is_offloaded(j_off.opt)
    ref = _planes(jx.off.tree_restore(j_off._replace(membership=None)))
    assert sorted(ref) == sorted(got)
    x_scale = _two_bf16_ulps(_f32(ref[".x0"]))
    for k in ref:
        a, b = _f32(got[k]), _f32(ref[k])
        if not bf16:
            rtol, atol = (1e-5, 1e-6) if opt_name == "sgd" else (2e-4, 1e-6)
            np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg=k)
        else:
            lim = 0 if k in (".step", ".opt.count") else (_two_bf16_ulps(b) if k.startswith(".opt") else x_scale)
            assert np.abs(a - b).max(initial=0.0) <= lim, (k, np.abs(a - b).max(), lim)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_reference_offloaded_state_carries_into_the_port(jx, rng, bf16):
    """``interop.state_from_numpy`` turns the reference's offloaded state
    (HostPlane chunk stacks) into the port's HostPlanes, stack for stack,
    equal to the port's own offloaded construction."""
    spec = _params_np(rng, bf16)
    cfg = _cfg("overlap_local_sgd", dict(anchor_beta=0.7), True)
    jstate = jx.training.make_train_state(_jparams(jx, spec), M, jx.optim.sgd(**OPT_KW["sgd"]),
                                          jx.core.make_strategy(jx.config.AlgoConfig(**cfg)), None)
    carried = interop.state_from_numpy(jx.jax.tree.map(np.asarray, jstate), packing.layout_of(_tparams(spec)))
    own = make_train_state(_tparams(spec), M, _topt("sgd"), make_strategy(AlgoConfig(**cfg)))
    for a, b in ((carried.opt.momentum, own.opt.momentum), (carried.vars.z, own.vars.z),
                 (carried.vars.v, own.vars.v), (carried.inflight, own.inflight)):
        assert isinstance(a, off.HostPlane) and a.plan == b.plan
        for sa, sb in zip(a.chunks, b.chunks):
            assert torch.equal(sa, sb)


# -- the engine's contract ---------------------------------------------------------


def test_train_state_built_offloaded(rng):
    cfg = AlgoConfig(**_cfg("overlap_local_sgd", dict(anchor_beta=0.7), True, tau=2))
    opt = _topt("sgd")
    assert offload_capable(opt)
    s = make_train_state(_tparams(_params_np(rng, True)), M, opt, make_strategy(cfg))
    assert isinstance(s.x, packing.Packed)
    assert off.is_offloaded(s.opt) and off.is_offloaded(s.vars) and off.is_offloaded(s.inflight)
    plan = off.plan_of(s.opt)
    assert plan is not None and all(k > 1 for k in plan.num_chunks)


def test_offload_requires_streamed_optimizer():
    """No quiet fallback to a resident step: an optimizer without
    ``step_streamed`` is refused."""
    crippled = dataclasses.replace(_topt("sgd"), step_streamed=None)
    assert not offload_capable(crippled)
    strat = make_strategy(AlgoConfig(**_cfg("overlap_local_sgd", {}, True, tau=2)))
    with pytest.raises(ValueError, match="offload"):
        make_round_step(_tloss, crippled, strat, schedules.constant(0.03))


def test_resident_state_is_adopted_and_trains_bitwise(rng):
    """A resident state handed to the offloaded engine is adopted into the
    host form on its first round, and trains as the resident engine does."""
    spec = _params_np(rng, False)
    opt = _topt("sgd")
    res_cfg, off_cfg = (AlgoConfig(**_cfg("overlap_local_sgd", dict(anchor_beta=0.7), o)) for o in (False, True))
    s_res = make_train_state(_tparams(spec), M, opt, make_strategy(res_cfg))
    s_adopt = make_train_state(_tparams(spec), M, opt, make_strategy(res_cfg))
    step_res = make_round_step(_tloss, opt, make_strategy(res_cfg), schedules.constant(0.03))
    step_off = make_round_step(_tloss, opt, make_strategy(off_cfg), schedules.constant(0.03))
    for A, b in _batches(spec, 3, 2):
        batch = (torch.from_numpy(A), torch.from_numpy(b))
        s_res, _ = step_res(s_res, batch)
        s_adopt, _ = step_off(s_adopt, batch)
        assert off.is_offloaded(s_adopt.opt) and off.is_offloaded(s_adopt.vars)
    got, want = _planes(off.tree_restore(s_adopt)), _planes(s_res)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_offloaded_fault_resync_matches_resident_and_reference(jx):
    """The reference's faulted run (crash:1@2-5, slow:2x4, m 4, seed 7): the
    re-sync reads a device copy of the host-resident anchor; the offloaded
    losses equal the resident ones bit for bit and the reference's within
    rtol 1e-4; worker 1 re-syncs."""
    from repro_torch.fault import FaultPlan

    kw = dict(name="overlap_local_sgd", tau=4, alpha=0.5, anchor_beta=0.7, offload_chunk_mb=CHUNK_MB)
    spec = "crash:1@2-5,slow:2x4"

    def run(offload):
        jexp = jx.api.Experiment(task=jx.api.ClassificationSpec(**SMALL),
                                 strategy=jx.config.AlgoConfig(offload=offload, **kw)).build()
        exp = Experiment(task=ClassificationSpec(**SMALL), strategy=AlgoConfig(offload=offload, **kw),
                         device="cpu").build()
        exp.state = interop.state_from_numpy(jx.jax.tree.map(np.asarray, jexp.state), packing.layout_of(exp.params))
        assert off.is_offloaded(exp.state.vars) == offload
        res = exp.fit(rounds=6, faults=FaultPlan.parse(spec, m=4, seed=7))
        jres = jexp.fit(rounds=6, faults=jx.fault.FaultPlan.parse(spec, m=4, seed=7))
        return res, jres

    (r_off, j_off), (r_res, _) = run(True), run(False)
    assert r_off.losses == r_res.losses
    assert r_off.losses[-1] < r_off.losses[0]
    np.testing.assert_allclose(r_off.losses, [float(v) for v in j_off.losses], rtol=1e-4)
    assert any(1 in r["resynced"] for r in r_off.fault_log), r_off.fault_log
    assert r_off.fault_log == r_res.fault_log


def test_anchor_plane_raises_when_offloaded():
    exp = Experiment(task=ClassificationSpec(**SMALL), strategy=AlgoConfig(offload=True, offload_chunk_mb=CHUNK_MB),
                     device="cpu")
    res = exp.fit(rounds=2)
    assert np.isfinite(res.losses).all() and off.is_offloaded(exp.state.vars.z)
    with pytest.raises(ValueError, match="anchor_plane"):
        exp.anchor_plane()
    # x stays on the device: the consensus reads it as on a resident state
    assert torch.equal(exp.consensus_plane().buffers[0], torch.mean(exp.state.x.buffers[0], dim=0))


# -- checkpoints of an offloaded state ---------------------------------------------


@pytest.mark.parametrize("opt_name", sorted(OPT_KW))
def test_offloaded_checkpoint_both_ways(jx, rng, tmp_path, opt_name):
    """The reference's offloaded checkpoint (chunk stacks under
    ``<slot>::<bucket>``, no layout) restores into the port bitwise, and the
    port's file, with the same keys, restores into the reference."""
    spec = _params_np(rng, True)
    name, kw = STRATEGY_VARIANTS[0]
    jstate = _jax_run(jx, spec, name, kw, opt_name, offload=True, rounds=1)
    tstate = _port_run(spec, name, kw, opt_name, offload=True, rounds=1)
    jpath, tpath = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jx.ckpt.save(jpath, jstate)
    checkpoint.save(tpath, tstate)
    with np.load(jpath) as a, np.load(tpath) as b:
        assert sorted(a.files) == sorted(b.files)
        assert "opt::momentum::0" in a.files or "opt::mu::0" in a.files
        assert not any(k.startswith("opt::") and k.endswith("__layout__") for k in a.files)
    template = _port_run(spec, name, kw, opt_name, offload=True, rounds=0)
    restored = checkpoint.restore(jpath, template)
    assert off.is_offloaded(restored.opt) and off.is_offloaded(restored.vars)
    carried = interop.state_from_numpy(jx.jax.tree.map(np.asarray, jstate), packing.layout_of(_tparams(spec)))
    for f in ("opt", "vars", "inflight"):
        for a, b in zip(off._nodes(getattr(restored, f)), off._nodes(getattr(carried, f))):
            assert a.plan == b.plan and all(torch.equal(sa, sb) for sa, sb in zip(a.chunks, b.chunks))
    got, want = _planes(off.tree_restore(restored)), _planes(off.tree_restore(carried))
    for k in want:
        assert torch.equal(got[k], want[k]), k
    jtemplate = _jax_run(jx, spec, name, kw, opt_name, offload=True, rounds=0)
    back = jx.ckpt.restore(tpath, jtemplate)
    assert jx.off.is_offloaded(back.opt) and jx.off.plan_of(back.opt) == jx.off.plan_of(jstate.opt)
    ref_port, back_planes = _planes(off.tree_restore(tstate)), _planes(jx.off.tree_restore(back))
    assert sorted(ref_port) == sorted(back_planes)
    for k in ref_port:
        np.testing.assert_array_equal(_f32(back_planes[k]), _f32(ref_port[k]), err_msg=k)


# -- K1/K2's window form on the card -----------------------------------------------

# (m, n, chunk elements): the classifier's plane (16 x 17,408 f32) cut into
# chunks of 4,096 columns (a ragged last chunk), and a 4 x 2^27 plane in the
# 64 MiB chunks of the default plan (2^24 f32 columns a chunk)
WINDOW_CASES = [(16, 17408, 4096), (4, 1 << 27, 1 << 24)]


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,c", WINDOW_CASES, ids=["classifier", "large"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_window_form_bitwise_on_card(cuda, m, n, c, dtype):
    """K1/K2 on every chunk window of a plane equal their plain versions on
    the same window and the whole-plane launch, bit for bit; the window form
    counts its own launches."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(m, n, generator=gen, device=cuda).to(dtype)
    g = torch.randn(m, n, generator=gen, device=cuda).to(dtype)
    mom = (0.1 * torch.randn(m, n, generator=gen, device=cuda)).to(dtype)
    mu = 0.1 * torch.randn(m, n, generator=gen, device=cuda)
    nu = torch.rand(m, n, generator=gen, device=cuda)
    lr = torch.full((), 0.05, device=cuda)
    c1, c2 = torch.full((), 1 - 0.9**3, device=cuda), torch.full((), 1 - 0.95**3, device=cuda)
    whole_x, whole_m = opt_ops.sgd_step(x.clone(), g, mom.clone(), lr, **OPT_KW["sgd"])
    wax, wamu, wanu = opt_ops.adamw_step(x.clone(), g, mu.clone(), nu.clone(), lr, c1, c2, **OPT_KW["adamw"])
    xs, xa = x.clone(), x.clone()
    before = opt_ops.SGD_WINDOW.launches, opt_ops.ADAMW_WINDOW.launches
    chunks = -(-n // c)
    for i in range(chunks):
        c0, w = i * c, min(c, n - i * c)
        sl = slice(c0, c0 + w)
        staged = torch.zeros(m, c, dtype=dtype, device=cuda)
        staged[:, :w] = mom[:, sl]
        want = opt_ref.sgd_update(x[:, sl], g[:, sl], mom[:, sl], lr, **OPT_KW["sgd"])
        opt_ops.sgd_step_window(xs[:, sl], g[:, sl], staged[:, :w], lr, **OPT_KW["sgd"])
        assert torch.equal(xs[:, sl], want[0]) and torch.equal(staged[:, :w], want[1])
        assert torch.equal(staged[:, w:], torch.zeros_like(staged[:, w:]))  # the tail untouched
        assert torch.equal(staged[:, :w], whole_m[:, sl])
        smu, snu = torch.zeros(m, c, device=cuda), torch.zeros(m, c, device=cuda)
        smu[:, :w], snu[:, :w] = mu[:, sl], nu[:, sl]
        want = opt_ref.adamw_update(x[:, sl], g[:, sl], mu[:, sl], nu[:, sl], lr, c1, c2, **OPT_KW["adamw"])
        opt_ops.adamw_step_window(xa[:, sl], g[:, sl], smu[:, :w], snu[:, :w], lr, c1, c2, **OPT_KW["adamw"])
        assert torch.equal(xa[:, sl], want[0]) and torch.equal(smu[:, :w], want[1]) and torch.equal(snu[:, :w], want[2])
        assert torch.equal(smu[:, :w], wamu[:, sl]) and torch.equal(snu[:, :w], wanu[:, sl])
    torch.cuda.synchronize()
    assert torch.equal(xs, whole_x) and torch.equal(xa, wax)
    assert (opt_ops.SGD_WINDOW.launches - before[0], opt_ops.ADAMW_WINDOW.launches - before[1]) == (chunks, chunks)


@pytest.mark.cuda
def test_window_form_rejects_strided_rows_on_card(cuda):
    x = torch.zeros(4, 256, device=cuda)
    lr = torch.full((), 0.05, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        opt_ops.sgd_step_window(x.t(), x.t(), x.t(), lr, **OPT_KW["sgd"])
    with pytest.raises(ValueError, match="strides"):
        opt_ops.sgd_step_window(x[:, :128], x.clone()[:, ::2][:, :128].contiguous(), x[:, :128], lr,
                                **OPT_KW["sgd"])


@pytest.mark.cuda
@pytest.mark.parametrize("opt_name", sorted(OPT_KW))
def test_streamed_step_on_card_equals_resident(cuda, opt_name):
    """The streamed step on the card (pinned stacks, the copy streams, the
    window launches) equals the resident step bit for bit, one window
    launch a chunk a bucket."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    tree = {"a": torch.randn(M, 5000, generator=gen, device=cuda),
            "b": torch.randn(M, 3, 700, generator=gen, device=cuda).bfloat16()}
    px = packing.pack(tree, lead=1)
    pg = packing.Packed(tuple((0.01 * b.float() + 0.003).to(b.dtype) for b in px.buffers), px.layout)
    opt, lr = _topt(opt_name), torch.full((), 0.05, device=cuda)
    plan = off.OffloadPlan.for_layout(px.layout, 1 / 256)
    st, x_res = opt.init_packed(px), packing.Packed(tuple(b.clone() for b in px.buffers), px.layout)
    host = off.tree_offload(st, plan)
    assert all(ch.is_pinned() for hp in off._nodes(host) for ch in hp.chunks)
    kern = opt_ops.SGD_WINDOW if opt_name == "sgd" else opt_ops.ADAMW_WINDOW
    before = kern.launches
    for _ in range(3):
        st, x_res = opt.step_packed(st, x_res, pg, lr)
        host, px = opt.step_streamed(host, px, pg, lr)
    back = off.tree_restore(host)
    torch.cuda.synchronize()
    assert kern.launches - before == 3 * sum(plan.num_chunks)
    for a, b in zip(px.buffers, x_res.buffers):
        assert torch.equal(a, b)
    for a, b in zip(_planes(back).values(), _planes(st).values()):
        assert torch.equal(a, b)


def test_init_on_device_draws_the_same_weights_on_the_cpu():
    """``Experiment(init_on_device=True)`` draws an LM's weights with a
    generator on the experiment's device (the full-width offloaded runs on
    the card use it); on the CPU that is the default draw, leaf for leaf."""
    from repro_torch.api import TokenStream

    kw = dict(arch="qwen2-7b", workers=2, data=TokenStream(1, 16), device="cpu")
    a, b = Experiment(**kw).build(), Experiment(init_on_device=True, **kw).build()
    for x, y in zip(packing.tree_flatten(a.params)[0], packing.tree_flatten(b.params)[0]):
        assert torch.equal(x, y)


@pytest.mark.cuda
def test_pageable_stacks_raise_on_card(cuda):
    """A HostPlane for a CUDA device whose stacks are pageable raises: a
    ``non_blocking`` copy from pageable memory would block the host."""
    px = packing.pack({"a": torch.ones(M, 300, device=cuda)}, lead=1)
    plan = off.OffloadPlan.for_layout(px.layout, CHUNK_MB)
    host = off.offload_plane(px, plan)
    pageable = off.HostPlane(tuple(ch.clone() for ch in host.chunks), host.layout, plan, cuda)
    assert all(ch.is_pinned() for ch in host.chunks) and not pageable.chunks[0].is_pinned()
    with pytest.raises(ValueError, match="pinned"):
        off.restore_plane(pageable)
    with pytest.raises(ValueError, match="pinned"):
        off.streamed_update(lambda *a: None, (pageable,), px, px)
    assert torch.equal(off.restore_plane(host).buffers[0], px.buffers[0])
