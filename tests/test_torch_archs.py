"""The port's other GQA text archs against the JAX reference, on the CPU:
the reduced h2o-danube-1.8b (sliding window 64, head_dim 64),
mistral-large-123b (group 4 at this size), command-r-35b (parallel blocks
with a bias-free LayerNorm and no ``ln2``, tied head, ``logit_scale``
0.0625) and arctic-480b (MoE segments: 4 experts top-2 with a dense
residual FFN; an f32 router in a model of any dtype), each from
``ModelConfig.reduced()`` as ``tests/test_archs_smoke.py`` builds them, plus
a ``use_qk_norm=True`` variant of the reduced h2o-danube (no registered arch
sets it).

Both packages get the same inputs: the reference's weights and its
``Experiment.build()`` state carried across by ``repro_torch.interop``, and
the same numpy token streams. On the CPU the port runs the plain versions of
its kernels. Stated tolerances and why:

* forward logits (f32): max|Δ| ≤ 1e-5·max|jax| (the matmuls, the softmax
  and the attention sum in other orders; observed ≈ 1.5e-6), ``moe_aux``
  rtol 1e-5;
* one Overlap-Local-SGD round (τ 2, m 2) in f32: x, z, v and the in-flight
  anchor rtol 1e-5, atol 1e-6, the losses rtol 1e-6 (the bounds of
  ``test_torch_lm.py``'s round test); the momentum, which holds the round's
  raw gradients, each leaf within 1e-5·max|leaf| (a tenth of
  ``test_torch_lm.py``'s gradient-plane bound: the reduced mistral-large's
  tok_emb gradient reaches 0.85 and sums rows over 64 tokens in another
  order, observed 1.4e-6 of it);
* one round in bf16: the bounds of ``test_torch_lm.py``'s bf16 round (x, z,
  v, in-flight within one bf16 ulp of max|x| of their bucket, the momentum
  within 4 ulps of its own largest value, the losses rtol 1e-3), the f32
  router's bucket held to the same bf16 ulps (its gradient comes through
  bf16 activations). The top-2 routing is discontinuous: one bf16
  rounding of a router input flips a near-tied choice, and a flipped token
  changes its output and every gradient through it. So arctic's bf16 round
  is held twice. With both packages' top-k replaced by one fixed expert
  table (the router's scores still give the gates and the router's
  gradient, and expert 0 drops tokens past its capacity), every plane of
  both buckets, momentum included, is held to the bounds above. With its
  own routing, its momentum and losses are held within twice the
  reference's own distance between its bf16 round and its f32 round from
  the same weights, a guard on the flipped tokens (the reference itself
  moves its momentum by 0.18 of a largest 0.79, and its losses by 0.03,
  between bf16 and f32; the port is 0.18 and 0.027 from its bf16 round);
* the paged engine: the same greedy tokens and the same scheduler events as
  the reference's engine (h2o-danube's decode runs past its 64-token
  window); dense ``generate`` (prefill, then decode against the dense
  caches, grown for ``moe`` segments too): the same greedy tokens as the
  reference's, past the window as well;
* command-r's ``logits * logit_scale``: bitwise (0.0625 is a power of two).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import Experiment as JExperiment
from repro.api import TokenStream as JTokenStream
from repro.config import AlgoConfig as JAlgo
from repro.config import OptimizerConfig as JOpt
from repro.config import get_arch as jax_get_arch
from repro.data import loaders as jloaders
from repro.models import transformer as JT
from repro.optim import schedules as jsched
from repro.parallel import packing as jpacking
from repro.serving import BatchedEngine as JaxEngine
from repro.serving import engine as jengine
from repro_torch import interop
from repro_torch.api import Experiment, TokenStream
from repro_torch.config import AlgoConfig, OptimizerConfig, get_arch
from repro_torch.models import transformer as T
from repro_torch.optim import schedules
from repro_torch.parallel import packing
from repro_torch.serving.engine import BatchedEngine, generate

ARCHS = ["h2o-danube-1.8b", "mistral-large-123b", "command-r-35b", "arctic-480b"]
QK = "h2o-danube-1.8b+qk_norm"
CASES = ARCHS + [QK]
WORKERS, BATCH, SEQ, LR = 2, 2, 32, 1e-2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small CPU ops: torch's thread pool only contends with XLA's here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(case, dtype="float32"):
    """The reduced config of both packages (the QK-norm variant of h2o-danube
    for ``QK``) in ``dtype``."""
    name, _, variant = case.partition("+")
    out = []
    for cfg in (jax_get_arch(name).model.reduced(), get_arch(name).model.reduced()):
        if variant == "qk_norm":
            cfg = dataclasses.replace(cfg, use_qk_norm=True)
        out.append(dataclasses.replace(cfg, dtype=dtype))
    return out


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape).astype(np.int32)


# -- configs and forward -----------------------------------------------------------


def test_configs_equal_the_reference():
    for name in ARCHS:
        j, t = jax_get_arch(name).model, get_arch(name).model
        jf, tf = dataclasses.asdict(j), dataclasses.asdict(t)
        assert jf == tf, name
        assert dataclasses.asdict(j.reduced()) == dataclasses.asdict(t.reduced()), name


@pytest.mark.parametrize("case", CASES)
def test_forward_logits_match_jax(case):
    jcfg, tcfg = _cfgs(case)
    jparams, _ = JT.init_model(jcfg, jax.random.PRNGKey(0))
    tparams = interop.params_from_numpy(_np(jparams))
    leaves, paths = packing.tree_flatten(tparams)
    jleaves = jax.tree.leaves(jparams)
    assert [tuple(t.shape) for t in leaves] == [tuple(a.shape) for a in jleaves]
    if jcfg.use_qk_norm:
        assert ("seg0", "qknorm", "q_norm", "scale") in paths
    if jcfg.use_parallel_block:
        assert ("seg0", "ln2", "scale") not in paths and ("head",) not in paths
    toks = _tokens(jcfg, (2, 40), 0)
    jl, jaux = JT.apply_model(jcfg, jparams, dict(tokens=jnp.asarray(toks)), mode="train")
    tl, taux = T.apply_model(tcfg, tparams, dict(tokens=torch.from_numpy(toks)), mode="train")
    jl = np.asarray(jl)
    assert tl.shape == jl.shape and bool(torch.isfinite(tl).all())
    assert np.abs(tl.numpy() - jl).max() <= 1e-5 * np.abs(jl).max()
    np.testing.assert_allclose(float(taux["moe_aux"]), float(jaux["moe_aux"]), rtol=1e-5)
    if jcfg.moe is not None:
        assert float(taux["moe_aux"]) > 0


def test_logit_scale_step_is_bitwise():
    """command-r's head in bf16: the port's ``_head`` is its unscaled logits
    times 0.0625, and scaling the reference's unscaled bf16 logits in torch
    gives the reference's scaled logits bit for bit."""
    jcfg, tcfg = _cfgs("command-r-35b", "bfloat16")
    assert jcfg.logit_scale == tcfg.logit_scale == 0.0625 and tcfg.tie_embeddings
    jparams, _ = JT.init_model(jcfg, jax.random.PRNGKey(0))
    tparams = interop.params_from_numpy(_np(jparams))
    hidden = jnp.asarray(np.random.default_rng(1).normal(size=(2, 9, jcfg.d_model)), jnp.bfloat16)
    jscaled = np.asarray(JT._head(jcfg, jparams, hidden).astype(jnp.float32))
    junscaled = JT._head(dataclasses.replace(jcfg, logit_scale=1.0), jparams, hidden)
    th = interop.params_from_numpy(np.asarray(hidden))
    tscaled = T._head(tcfg, tparams, th)
    tunscaled = T._head(dataclasses.replace(tcfg, logit_scale=1.0), tparams, th)
    assert tscaled.dtype == torch.bfloat16
    assert torch.equal(tscaled, tunscaled * 0.0625)
    from_jax = interop.params_from_numpy(np.asarray(junscaled)) * tcfg.logit_scale
    assert np.array_equal(from_jax.float().numpy(), jscaled)


# -- one Overlap-Local-SGD round ---------------------------------------------------------


def _pair(case, dtype):
    """A JAX LM experiment and a port LM experiment of one configuration, the
    port starting from the JAX experiment's built state."""
    jcfg, tcfg = _cfgs(case, dtype)
    kw = dict(workers=WORKERS, rounds=1)
    j = JExperiment(arch=jcfg, strategy=JAlgo(), optimizer=JOpt(name="sgd", lr=LR), schedule=jsched.constant(LR),
                    data=JTokenStream(BATCH, SEQ), **kw).build()
    p = Experiment(arch=tcfg, strategy=AlgoConfig(), optimizer=OptimizerConfig(name="sgd", lr=LR),
                   schedule=schedules.constant(LR), data=TokenStream(BATCH, SEQ), device="cpu", **kw).build()
    p.state = interop.state_from_numpy(_np(j.state), packing.layout_of(p.params))
    return j, p


def _planes(state):
    out = {}
    for name, p in (("x", state.x), ("momentum", state.opt.momentum), ("z", state.vars.z), ("v", state.vars.v),
                    ("inflight", state.inflight)):
        for i, b in enumerate(p.buffers):
            out[f"{name}{i}"] = np.asarray(b.float() if isinstance(b, torch.Tensor) else b.astype(jnp.float32))
    out["step"] = np.asarray(state.step)
    return out


def _round(case, dtype):
    """(the reference's experiment, one round's batch, the two packages'
    states and metrics after one round from the same state)."""
    j, p = _pair(case, dtype)
    before, carried = _planes(j.state), _planes(p.state)  # bf16 -> f32 is exact: equal means bitwise
    assert sorted(before) == sorted(carried) and all(np.array_equal(before[k], carried[k]) for k in before)
    rb = jloaders.round_batch(jloaders.lm_batch_fn(j.model_cfg, WORKERS, BATCH, SEQ, seed=3), 2)
    pstate, pms = p.step_fn(p.state, p.to_device(_np(rb)))  # in place: p.state is the new state too
    jstate, jms = j.step_fn(j.state, rb)
    return j, rb, jstate, pstate, jms, pms


@pytest.mark.parametrize("case", CASES)
def test_one_round_matches_jax(case):
    _, _, jstate, pstate, jms, pms = _round(case, "float32")
    want, got, layout = _planes(jstate), _planes(pstate), pstate.x.layout
    assert layout.bucket_dtypes == ("float32",)
    for k in want:
        if k.startswith("momentum"):
            for s in layout.slots:
                w, g = (a[:, s.offset : s.offset + s.size] for a in (want[k], got[k]))
                assert np.abs(g - w).max() <= 1e-5 * np.abs(w).max(), (k, layout.paths[s.index])
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(pms["loss"].numpy(), np.asarray(jms["loss"]), rtol=1e-6)
    assert sorted(pms) == sorted(jms)
    if "moe_aux" in jms:
        np.testing.assert_allclose(pms["moe_aux"].numpy(), np.asarray(jms["moe_aux"]), rtol=1e-5)


def _ulps(a, n):
    return n * np.ldexp(np.float32(1), np.frexp(np.abs(a).max())[1] - 8)


def reference_f32_round(j, rb):
    """The reference's own round in f32 from ``j``'s bf16 state widened
    (leaf by leaf: the f32 model packs into one bucket), and its metrics:
    (planes as lists of f32 leaves by name, metrics)."""
    j32 = JExperiment(arch=dataclasses.replace(j.model_cfg, dtype="float32"), strategy=JAlgo(),
                      optimizer=JOpt(name="sgd", lr=LR), schedule=jsched.constant(LR), data=JTokenStream(BATCH, SEQ),
                      workers=WORKERS, rounds=1).build()

    def wide(plane, like):
        tree = jax.tree.map(lambda a: a.astype(jnp.float32), jpacking.unpack(plane))
        return jpacking.pack(tree, like.layout, lead=len(plane.lead_shape))

    s, s32 = j.state, j32.state
    s32 = s32._replace(x=wide(s.x, s32.x), opt=type(s32.opt)(momentum=wide(s.opt.momentum, s32.opt.momentum)),
                       vars=s32.vars._replace(z=wide(s.vars.z, s32.vars.z), v=wide(s.vars.v, s32.vars.v)),
                       inflight=wide(s.inflight, s32.inflight))
    state, ms = j32.step_fn(s32, rb)
    return state, ms


def _leaves(plane):
    if isinstance(plane, packing.Packed):
        return [t.float().numpy() for t in packing.tree_flatten(packing.unpack(plane))[0]]
    return [np.asarray(a, np.float32) for a in jax.tree.leaves(jpacking.unpack(plane))]


def _distance(a, b) -> float:
    return max(float(np.abs(x - y).max()) for x, y in zip(_leaves(a), _leaves(b)))


def _assert_bf16_planes_close(jstate, pstate, momentum=True):
    """Every plane bucket by bucket: x, z, v and in-flight within one bf16
    ulp of max|x| of their bucket, the momentum (unless ``momentum`` is
    false) within 4 ulps of its own largest value, the step exact."""
    want, got = _planes(jstate), _planes(pstate)
    for k in want:
        if k.startswith("momentum") and not momentum:
            continue
        lim = 0 if k == "step" else _ulps(want[k], 4) if k.startswith("momentum") else _ulps(want["x" + k[-1]], 1)
        assert np.abs(got[k] - want[k]).max() <= lim, (k, np.abs(got[k] - want[k]).max(), lim)


@pytest.mark.parametrize("arch", ARCHS)
def test_one_round_bf16_matches_jax(arch):
    """bf16 parameters (arctic: a bf16 bucket and the router's f32 bucket).
    Bounds: those of ``test_torch_lm.py::test_one_round_bf16_matches_jax``,
    bucket by bucket, in bf16 ulps; arctic's momentum and losses within
    twice the reference's own bf16-to-f32 distance (see the module
    docstring)."""
    j, rb, jstate, pstate, jms, pms = _round(arch, "bfloat16")
    moe = arch == "arctic-480b"
    assert pstate.x.layout.bucket_dtypes == (("bfloat16", "float32") if moe else ("bfloat16",))
    _assert_bf16_planes_close(jstate, pstate, momentum=not moe)
    if not moe:
        np.testing.assert_allclose(pms["loss"].numpy(), np.asarray(jms["loss"]), rtol=1e-3)
        return
    ref32, ms32 = reference_f32_round(j, rb)
    own = _distance(jstate.opt.momentum, ref32.opt.momentum)
    port = _distance(jstate.opt.momentum, pstate.opt.momentum)
    assert 0 < port <= 2 * own, (port, own)
    own_loss = float(np.abs(np.asarray(jms["loss"]) - np.asarray(ms32["loss"])).max())
    port_loss = float(np.abs(np.asarray(jms["loss"]) - pms["loss"].numpy()).max())
    assert port_loss <= 2 * own_loss, (port_loss, own_loss)


def _fixed_routing(t, e, k):
    """The (t, k) expert table that both packages' top-k return in
    :func:`test_arctic_bf16_round_under_fixed_routing_matches_jax`: the
    first three quarters of the tokens choose expert 0 first (more than its
    capacity, so some are dropped), the rest expert ``t % e``; the second
    choice is another expert."""
    assert k == 2 and e > 1
    tok = np.arange(t)
    first = np.where(tok < 3 * t // 4, 0, tok % e)
    return np.stack([first, (first + 1 + tok % (e - 1)) % e], axis=1)


def test_arctic_bf16_round_under_fixed_routing_matches_jax(monkeypatch):
    """The reduced arctic's bf16 + f32 plane with the routing decision taken
    out of the comparison: both packages' top-k return the experts of
    :func:`_fixed_routing` and the router's scores at them, so the gates,
    the router's gradient, the capacity drops, the dispatch and the combine
    all run, but no near-tied choice can flip between the packages. Bounds:
    the bf16 round's above, on both buckets, momentum included (the f32
    router's bucket at the same bf16 ulps: its gradient comes through bf16
    activations); the losses rtol 1e-3, ``moe_aux`` rtol 1e-3."""
    from types import SimpleNamespace

    from repro.models.layers import moe as jmoe
    from repro_torch.models.layers import moe as tmoe

    calls = {"jax": 0, "torch": 0}

    def jax_top_k(scores, k):
        calls["jax"] += 1
        idx = jnp.asarray(_fixed_routing(*scores.shape, k), jnp.int32)
        return jnp.take_along_axis(scores, idx, axis=1), idx

    def torch_top_k(scores, k):
        calls["torch"] += 1
        idx = torch.from_numpy(_fixed_routing(*scores.shape, k)).to(scores.device)
        return torch.gather(scores, 1, idx), idx

    monkeypatch.setattr(jmoe, "jax", SimpleNamespace(nn=jax.nn, lax=SimpleNamespace(top_k=jax_top_k)))
    monkeypatch.setattr(tmoe, "_top_k", torch_top_k)
    cfg = get_arch("arctic-480b").model.reduced().moe
    table = _fixed_routing(BATCH * SEQ, cfg.num_experts, cfg.top_k)
    assert (table == 0).sum() > tmoe.capacity_of(BATCH * SEQ, cfg)  # expert 0 drops tokens
    _, _, jstate, pstate, jms, pms = _round("arctic-480b", "bfloat16")
    assert calls["jax"] > 0 and calls["torch"] > 0, calls
    assert pstate.x.layout.bucket_dtypes == ("bfloat16", "float32")
    _assert_bf16_planes_close(jstate, pstate)
    np.testing.assert_allclose(pms["loss"].float().numpy(), np.asarray(jms["loss"], np.float32), rtol=1e-3)
    np.testing.assert_allclose(pms["moe_aux"].float().numpy(), np.asarray(jms["moe_aux"], np.float32), rtol=1e-3)


# -- serving ------------------------------------------------------------------------


@pytest.mark.parametrize("case", CASES)
def test_paged_engine_matches_jax_engine(case):
    """Both packages' engines from the reference's weights: five requests
    over two slots with a mid-run arrival, prompts of 5 to 70 tokens; the
    same greedy tokens and scheduler events. h2o-danube's 70-token prompt
    with 12 new tokens decodes at positions 70-81, past its 64-token
    window."""
    jcfg, tcfg = _cfgs(case)
    jparams, _ = JT.init_model(jcfg, jax.random.PRNGKey(0))
    tparams = interop.params_from_numpy(_np(jparams))
    rng = np.random.default_rng(7)
    lens = [70, 5, 23, 12, 40]
    trace = [(f"r{i}", rng.integers(1, jcfg.vocab_size, (n,)).astype(np.int32), 12 if i == 0 else 4)
             for i, n in enumerate(lens)]

    def drive(engine):
        for rid, prompt, mn in trace[:4]:
            engine.submit(rid, prompt, mn)
        steps = 0
        while engine.sched.busy:
            engine.step()
            steps += 1
            if steps == 2:
                engine.submit(*trace[4])
        return {k: np.asarray(v).tolist() for k, v in engine.results.items()}, list(engine.sched.events)

    kw = dict(slots=2, max_len=96, page_size=8, chunk=16)
    jres, jev = drive(JaxEngine(jcfg, jparams, **kw))
    eng = BatchedEngine(tcfg, tparams, device="cpu", **kw)
    assert eng.paged
    tres, tev = drive(eng)
    assert tev == jev and tres == jres
    assert all(len(tres[rid]) == mn for rid, _, mn in trace)


@pytest.mark.parametrize("case", CASES)
def test_dense_generate_matches_jax(case):
    """Dense ``generate`` at B 2 from a 70-token prompt, 10 new tokens (past
    h2o-danube's 64-token window): the reference's greedy tokens."""
    jcfg, tcfg = _cfgs(case)
    jparams, _ = JT.init_model(jcfg, jax.random.PRNGKey(0))
    tparams = interop.params_from_numpy(_np(jparams))
    prompt = _tokens(jcfg, (2, 70), 5)
    want = np.asarray(jengine.generate(jcfg, jparams, jnp.asarray(prompt), max_new=10))
    got = generate(tcfg, tparams, prompt, max_new=10)
    assert got.shape == (2, 10) and got.tolist() == want.tolist()
