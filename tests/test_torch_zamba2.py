"""The port's zamba2 slice (repro_torch) against the JAX reference, on the CPU:
the Mamba2 SSD scan's plain version and its autograd, the Mamba2 block, and
the reduced zamba2-1.2b ([mamba2, shared_attn], d_model 256, tied
embeddings, SSM heads of 32 with state 16, chunk 16), also at six layers
with the shared block at two positions, trained with Overlap-Local-SGD (τ 2, α 0.6, β 0.7, packed) and SGD + Nesterov at the
training CLI's lr 1e-2.

Both packages get the same inputs: numpy arrays from a seed, the token
stream as a numpy copy, and the reference's ``Experiment.build()`` state
carried across bit for bit by ``repro_torch.interop``. On the CPU the port
runs the plain ``ssd_chunked``, which is also the reference model's CPU
route (its D-skip term added in f32 and rounded once with y). Each test
states its bound and, in a comment, the value observed here.
"""
import copy
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

from repro.api import Experiment as JExperiment
from repro.api import TokenStream as JTokenStream
from repro.config import AlgoConfig as JAlgo
from repro.config import OptimizerConfig as JOpt
from repro.config import get_arch as jax_get_arch
from repro.data import loaders as jloaders
from repro.kernels import flags as jflags
from repro.kernels.ssd_scan import ops as jssd_ops
from repro.kernels.ssd_scan import ref as jssd_ref
from repro.models import params as JP
from repro.models import transformer as JT
from repro.models.layers import mamba2 as jmamba
from repro.optim import schedules as jsched
from repro_torch import interop
from repro_torch.api import Experiment, TokenStream
from repro_torch.config import AlgoConfig, OptimizerConfig, SSMConfig, get_arch
from repro_torch.data import loaders
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan import ref as ssd_ref
from repro_torch.launch import train as train_cli
from repro_torch.models import transformer as T
from repro_torch.models.layers import mamba2
from repro_torch.optim import schedules
from repro_torch.parallel import packing
from repro_torch.training.train_loop import gradient_plane

SRC = Path(__file__).resolve().parents[1] / "src"
WORKERS, BATCH, SEQ, LR = 4, 2, 40, 1e-2  # seq 40: two whole chunks of 16 and a ragged one


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small CPU ops: torch's thread pool only contends with XLA's here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _ssd_inputs(rng, b, s, h, p, g, n):
    """x, dt, A, B, C, D as in the reference's kernel sweep (tests/test_kernels.py)."""
    return (rng.normal(size=(b, s, h, p)).astype(np.float32),
            (np.abs(rng.normal(size=(b, s, h))) * 0.5).astype(np.float32),
            (-np.abs(rng.normal(size=(h,)))).astype(np.float32),
            rng.normal(size=(b, s, g, n)).astype(np.float32), rng.normal(size=(b, s, g, n)).astype(np.float32),
            rng.normal(size=(h,)).astype(np.float32))


# -- the SSD scan ----------------------------------------------------------------

# the reference sweep's three cases (tests/test_kernels.py:77), the reduced
# zamba2's SSM shape with a ragged last chunk, and S shorter than one chunk
SSD_CASES = [(2, 32, 4, 8, 2, 5, 8), (1, 37, 2, 16, 1, 8, 16), (2, 64, 4, 8, 4, 4, 64), (2, 45, 16, 32, 1, 16, 16),
             (1, 20, 2, 8, 1, 8, 32)]


@pytest.mark.parametrize("b,s,h,p,g,n,chunk", SSD_CASES, ids=["grouped", "ragged", "one_chunk", "reduced", "short"])
def test_ssd_plain_matches_jax(rng, b, s, h, p, g, n, chunk):
    """The port's ``ssd_scan`` (on the CPU, the plain ``ssd_chunked``)
    against JAX's ``ssd_chunked``: 1e-5·max|·| for y and the final state
    (observed ≤ 4.6e-7); against the reference's scan and, where S is a
    whole number of chunks, the Pallas kernel in interpret mode: the
    reference test's 5e-4 for y and 5e-3 for the state, absolute (observed
    ≤ 9.6e-6); the port's own scan against the reference's the same."""
    ins = _ssd_inputs(rng, b, s, h, p, g, n)
    y, st = ssd_ops.ssd_scan(*map(torch.from_numpy, ins), chunk=chunk)
    jy, jst = jssd_ref.ssd_chunked(*map(jnp.asarray, ins), chunk=chunk)
    assert y.shape == (b, s, h, p) and st.shape == (b, h, p, n) and st.dtype == torch.float32
    assert _rel(y, jy) <= 1e-5 and _rel(st, jst) <= 1e-5
    ry, rst = jssd_ref.ssd_reference(*map(jnp.asarray, ins))
    np.testing.assert_allclose(y.numpy(), np.asarray(ry), rtol=5e-4, atol=5e-4)
    np.testing.assert_allclose(st.numpy(), np.asarray(rst), rtol=5e-3, atol=5e-3)
    py, pst = ssd_ref.ssd_reference(*map(torch.from_numpy, ins))
    np.testing.assert_allclose(py.numpy(), np.asarray(ry), rtol=5e-4, atol=5e-4)
    np.testing.assert_allclose(pst.numpy(), np.asarray(rst), rtol=5e-3, atol=5e-3)
    if s % chunk == 0:
        with jflags.force_pallas():
            iy, ist = jssd_ops.ssd_scan(*map(jnp.asarray, ins), chunk)
        np.testing.assert_allclose(y.numpy(), np.asarray(iy), rtol=5e-4, atol=5e-4)
        np.testing.assert_allclose(st.numpy(), np.asarray(ist), rtol=5e-3, atol=5e-3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_autograd_matches_jax_vjp(rng, dtype):
    """Torch autograd of the port's ``ssd_scan`` (its CPU route) against
    ``jax.vjp`` of ``ssd_chunked``, with cotangents for y and the final
    state; x, B, C and D in ``dtype``, dt and A in f32, at the reduced
    zamba2's SSM shape with a ragged last chunk. Bound, as max|Δ|/max|JAX|:
    f32 1e-5 (observed ≤ 7.8e-7); bf16 2^-8 (both compute in f32 between
    one cast in and one out, but XLA and torch round the same f32 sums to
    bf16 from values that differ in their last f32 bits; observed ≤ 7.9e-7).
    In bf16, dB and dC are held against the reference's gradient with B and
    C given in f32 (the same values): the reference's bf16 route rounds each
    head's share to bf16 and sums a group's heads in bf16 (6.5e-3 from its
    own f32 route here, 8 heads a group), the port sums them in f32 and
    rounds once (observed 1.9e-3); against the bf16 route 2^-6 (observed
    8.0e-3)."""
    b, s, h, p, g, n, chunk = 2, 45, 8, 32, 1, 16, 16
    x, dt, A, B, C, D = _ssd_inputs(rng, b, s, h, p, g, n)
    dy = rng.normal(size=(b, s, h, p)).astype(np.float32)
    dst = rng.normal(size=(b, h, p, n)).astype(np.float32)
    jd = jnp.dtype(dtype)
    jins = [jnp.asarray(x, jd), jnp.asarray(dt), jnp.asarray(A), jnp.asarray(B, jd), jnp.asarray(C, jd),
            jnp.asarray(D, jd)]
    jct = (jnp.asarray(dy, jd), jnp.asarray(dst))
    (jy, jst), vjp = jax.vjp(lambda *a: jssd_ref.ssd_chunked(*a, chunk=chunk), *jins)
    jgrads = list(vjp(jct))
    tins = [interop.params_from_numpy(np.asarray(a)).requires_grad_(True) for a in jins]
    y, st = ssd_ops.ssd_scan(*tins, chunk=chunk)
    assert y.dtype == tins[0].dtype and st.dtype == torch.float32
    grads = torch.autograd.grad((y, st), tins, (interop.params_from_numpy(np.asarray(jct[0])), torch.from_numpy(dst)))
    bound = 1e-5 if dtype == "float32" else 2.0**-8
    if dtype == "bfloat16":
        for i in (3, 4):
            assert _rel(grads[i].float(), jnp.asarray(jgrads[i], jnp.float32)) <= 2.0**-6
        f32_bc = jins[:3] + [jins[3].astype(jnp.float32), jins[4].astype(jnp.float32), jins[5]]
        _, vjp32 = jax.vjp(lambda *a: jssd_ref.ssd_chunked(*a, chunk=chunk), *f32_bc)
        jgrads[3:5] = vjp32(jct)[3:5]
    assert _rel(y.float().detach(), jnp.asarray(jy, jnp.float32)) <= bound
    assert _rel(st.detach(), jst) <= bound
    for name, got, want, t in zip(("x", "dt", "A", "B", "C", "D"), grads, jgrads, tins):
        assert got.dtype == t.dtype, name
        assert _rel(got.float(), jnp.asarray(want, jnp.float32)) <= bound, (name, _rel(got.float(), want))


def test_dskip_rounds_once_as_the_reference_cpu_route(rng):
    """bf16 x, B, C and D at the reduced zamba2's SSM shape (S a whole
    number of chunks). The port rounds y once after adding x·D in f32, as
    the reference's ``ssd_chunked`` (its model's CPU route): within one bf16
    ulp of each element (observed: equal). The reference's Pallas route
    (interpret mode) rounds y to bf16, then adds x·D in bf16, so the port
    is held within 2^-7·max|y| of it (observed 4.8e-3; between seeds 0-2,
    ≤ 5.6e-3)."""
    b, s, h, p, g, n, chunk = 2, 32, 16, 32, 1, 16, 16
    ins = list(_ssd_inputs(rng, b, s, h, p, g, n))
    jins = [jnp.asarray(a, jnp.bfloat16) if i in (0, 3, 4, 5) else jnp.asarray(a) for i, a in enumerate(ins)]
    ty, _ = ssd_ops.ssd_scan(*(interop.params_from_numpy(np.asarray(a)) for a in jins), chunk=chunk)
    jy, _ = jssd_ref.ssd_chunked(*jins, chunk=chunk)
    with jflags.force_pallas():
        iy, _ = jssd_ops.ssd_scan(*jins, chunk)
    got, want = ty.float().numpy(), np.asarray(jy.astype(jnp.float32))
    assert (np.abs(got - want) <= _bf16_ulp(want)).all()
    assert _rel(got, iy.astype(jnp.float32)) <= 2.0**-7


def _bf16_ulp(a):
    """One bf16 ulp of each element of the f32 array ``a``."""
    return np.ldexp(np.float32(1), np.frexp(np.maximum(np.abs(a), np.float32(2.0**-126)))[1] - 8)


def test_ssd_decode_step_matches_jax(rng):
    """``ssd_decode_step`` token by token against the reference's, and
    against the scan: 5e-4 absolute, as the reference's own test (observed
    ≤ 2.4e-7)."""
    b, s, h, p, g, n = 1, 9, 2, 4, 1, 3
    ins = _ssd_inputs(rng, b, s, h, p, g, n)
    x, dt, A, B, C, D = map(torch.from_numpy, ins)
    jx_, jdt, jA, jB, jC, jD = map(jnp.asarray, ins)
    state, jstate = torch.zeros(b, h, p, n), jnp.zeros((b, h, p, n), jnp.float32)
    ys = []
    for t in range(s):
        y, state = ssd_ops.ssd_decode_step(state, x[:, t], dt[:, t], A, B[:, t], C[:, t], D)
        jy, jstate = jssd_ops.ssd_decode_step(jstate, jx_[:, t], jdt[:, t], jA, jB[:, t], jC[:, t], jD)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-6, atol=1e-6)
        ys.append(y)
    np.testing.assert_allclose(state.numpy(), np.asarray(jstate), rtol=1e-6, atol=1e-6)
    ry, _ = jssd_ref.ssd_reference(jx_, jdt, jA, jB, jC, jD)
    np.testing.assert_allclose(torch.stack(ys, 1).numpy(), np.asarray(ry), rtol=5e-4, atol=5e-4)


def test_ssd_rejects_bad_inputs():
    x, dt, A, bc, D = torch.zeros(1, 4, 2, 8), torch.zeros(1, 4, 2), torch.zeros(2), torch.zeros(1, 4, 1, 4), torch.ones(2)
    with pytest.raises(ValueError, match=r"A \(H,\)"):
        ssd_ops.ssd_scan(x, dt, torch.zeros(3), bc, bc, D)
    with pytest.raises(ValueError, match="B, C"):
        ssd_ops.ssd_scan(x, dt, A, bc, bc[:, :3], D)
    with pytest.raises(ValueError, match="must divide"):
        ssd_ops.ssd_scan(x, dt, A, torch.zeros(1, 4, 3, 4), torch.zeros(1, 4, 3, 4), D)
    with pytest.raises(ValueError, match="chunk"):
        ssd_ops.ssd_scan(x, dt, A, bc, bc, D, chunk=0)
    with pytest.raises(ValueError, match=r"D must be"):
        ssd_ops.ssd_scan(x, dt, A, bc, bc, torch.ones(3))
    with pytest.raises(ValueError, match="tensors on"):  # the kernel wrapper takes CUDA tensors only
        ssd_ops.ssd_scan_bh(x, dt, A, bc, bc)


# -- the Mamba2 block ------------------------------------------------------------


# a deeper reduced zamba2 at the same widths: the shared block at positions
# 2 and 5 (every third layer, as the full model's every seventh), so its
# gradient sums two uses a worker step, seg1 is a gap inside the seg{i}
# numbering and seg3 a trailing one
DEEP = ("mamba2", "mamba2", "shared_attn") * 2


def _cfgs(dtype="float32", pattern=None):
    """The reduced zamba2-1.2b of both packages; with ``pattern``, that
    layer pattern at the reduced widths."""
    cfgs = [dataclasses.replace(c, dtype=dtype)
            for c in (jax_get_arch("zamba2-1.2b").model.reduced(), get_arch("zamba2-1.2b").model.reduced())]
    if pattern is None:
        return cfgs
    return [dataclasses.replace(c, num_layers=len(pattern), layer_pattern=pattern, shared_attn_every=3) for c in cfgs]


def test_reduced_config_equals_the_reference():
    jcfg, tcfg = _cfgs()
    assert (tcfg.d_model, tcfg.d_ff, tcfg.vocab_size, tcfg.num_layers) == (256, 1024, 512, 2)
    assert tcfg.layer_pattern == ("mamba2", "shared_attn") and tcfg.shared_attn_every == 2 and tcfg.tie_embeddings
    assert tcfg.ssm == SSMConfig(kind="mamba2", state_dim=16, num_heads=4, head_dim=32, chunk_size=16)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg) | {"dtype": "float32"}
    full, jfull = get_arch("zamba2-1.2b").model, jax_get_arch("zamba2-1.2b").model
    assert dataclasses.asdict(full) == dataclasses.asdict(jfull)
    assert [k for k, _ in T.segments(full)] == [k for k, _ in JT.segments(jfull)]
    assert sum(n for k, n in T.segments(full) if k == "mamba2") == 33 and full.num_layers == 38


def test_softplus_is_the_references(rng):
    """``softplus`` is ``jax.nn.softplus`` (``logaddexp(x, 0)``), value and
    gradient, also above 20 where ``F.softplus`` returns x: rtol 1e-6
    (observed ≤ 1.7e-7)."""
    x = np.concatenate([rng.normal(size=64) * 4, [-30.0, -1e-3, 0.0, 19.5, 20.5, 40.0]]).astype(np.float32)
    t = torch.from_numpy(x).requires_grad_(True)
    y = mamba2.softplus(t)
    (g,) = torch.autograd.grad(y.sum(), t)
    jy, jg = jax.value_and_grad(lambda a: jax.nn.softplus(a).sum())(jnp.asarray(x))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jax.nn.softplus(jnp.asarray(x))), rtol=1e-6, atol=0)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-6, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba2_apply_matches_jax(rng, dtype):
    """One Mamba2 block of the reduced config's shapes (weights drawn by the
    reference, carried across; a_log and dt_bias spread so that A and dt
    vary by head) on seeded activations. f32: the output, and the gradients
    of a seeded projection of it for every weight and the input, within
    1e-5·max|·| (observed ≤ 1.5e-6). bf16: the output within 2^-6·max|y|
    (the causal conv, the gate and the norm round to bf16 at every op in
    torch and at fusion ends in XLA; observed 1.0e-2); its gradients are
    held in the bf16 LM round below."""
    jcfg, tcfg = _cfgs(dtype)
    d = jcfg.d_model
    jd = jnp.dtype(dtype)
    jparams, _ = JP.build(lambda b: jmamba.init_mamba2(b, "m", d, jcfg.ssm), jax.random.PRNGKey(5), jd)
    heads = jparams["m"]["a_log"].shape[0]
    jparams["m"]["a_log"] = jnp.asarray(rng.normal(size=heads) * 0.5, jd)
    jparams["m"]["dt_bias"] = jnp.asarray(rng.normal(size=heads), jd)
    tparams = interop.params_from_numpy(_np(jparams))
    x = rng.normal(size=(2, SEQ, d)).astype(np.float32)
    proj = rng.normal(size=(2, SEQ, d)).astype(np.float32)

    def jloss(prm, xx):
        out, _ = jmamba.mamba2_apply(prm, jcfg.ssm, xx)
        return jnp.sum(out.astype(jnp.float32) * proj), out

    (_, jy), jgrads = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(jparams["m"], jnp.asarray(x, jd))
    leaves, paths = packing.tree_flatten(tparams["m"])
    leaves = [t.requires_grad_(True) for t in leaves]
    tx = interop.params_from_numpy(np.asarray(jnp.asarray(x, jd))).requires_grad_(True)
    with pytest.raises(ValueError, match="one token and a cache"):
        mamba2.mamba2_apply(tparams["m"], tcfg.ssm, tx, mode="decode")
    ty, _ = mamba2.mamba2_apply(packing.tree_unflatten(paths, leaves), tcfg.ssm, tx)
    grads = torch.autograd.grad(torch.sum(ty.float() * torch.from_numpy(proj)), leaves + [tx])
    bound = 1e-5 if dtype == "float32" else 2.0**-6
    assert ty.dtype == tx.dtype and _rel(ty.float().detach(), jnp.asarray(jy, jnp.float32)) <= bound
    if dtype == "bfloat16":
        return
    jflat = jax.tree.leaves(jgrads[0]) + [jgrads[1]]
    for path, got, want in zip(list(paths) + [("x",)], grads, jflat):
        assert _rel(got.float(), jnp.asarray(want, jnp.float32)) <= bound, (path, _rel(got.float(), want))


# -- the reduced model -----------------------------------------------------------


def _pair(dtype="float32", pattern=None):
    """A JAX LM experiment and a port LM experiment of the reduced
    zamba2-1.2b (or ``pattern`` at its widths), the port starting from the
    JAX experiment's built state."""
    jcfg, tcfg = _cfgs(dtype, pattern)
    kw = dict(workers=WORKERS, rounds=3)
    j = JExperiment(arch=jcfg, strategy=JAlgo(), optimizer=JOpt(name="sgd", lr=LR), schedule=jsched.constant(LR),
                    data=JTokenStream(BATCH, SEQ), **kw).build()
    p = Experiment(arch=tcfg, strategy=AlgoConfig(), optimizer=OptimizerConfig(name="sgd", lr=LR),
                   schedule=schedules.constant(LR), data=TokenStream(BATCH, SEQ), device="cpu", **kw).build()
    p.state = interop.state_from_numpy(_np(j.state), packing.layout_of(p.params))
    return j, p


@pytest.fixture(scope="module")
def pair():
    return _pair()


def _planes(state):
    out = {}
    for name, p in (("x", state.x), ("momentum", state.opt.momentum), ("z", state.vars.z), ("v", state.vars.v),
                    ("inflight", state.inflight)):
        for i, b in enumerate(p.buffers):
            out[f"{name}{i}"] = np.asarray(b.float() if isinstance(b, torch.Tensor) else b.astype(jnp.float32))
    out["step"] = np.asarray(state.step)
    return out


def test_state_transfer_is_bitwise(pair):
    """The tree's leaves in the reference's order: the top-level
    ``shared_block`` and ``tok_emb`` (tied, no ``head``), ``seg0`` and no
    ``seg1`` (the shared position owns no parameters)."""
    j, p = pair
    want, got = _planes(j.state), _planes(p.state)
    assert sorted(want) == sorted(got)
    for key in want:
        assert np.array_equal(want[key], got[key]), key
    assert p.num_params == j.num_params
    jleaves = jax.tree_util.tree_leaves_with_path(j.params)
    tpaths = packing.layout_of(p.params).paths
    assert [tuple(str(getattr(k, "key", k)) for k in path) for path, _ in jleaves] == [tuple(t) for t in tpaths]
    assert {t[0] for t in tpaths} == {"final_norm", "seg0", "shared_block", "tok_emb"}


def test_loss_and_gradient_plane_match_jax(pair):
    """The loss rtol 1e-6 (observed 1.5e-7); each leaf of one step's
    gradient plane, worker by worker, within 1e-4·max|leaf| of ``jax.grad``
    (observed ≤ 8.2e-6), the tied ``tok_emb`` (the gather's and the head's
    gradients summed) and the shared block among them; every leaf of every
    worker non-zero."""
    j, p = pair
    cfg = j.model_cfg
    batch = jloaders.lm_batch_fn(cfg, WORKERS, BATCH, SEQ, seed=11)()
    params = jax.tree.map(lambda t: jnp.stack([t] * WORKERS), j.params)

    def loss(prm, b):
        return JT.lm_loss(cfg, prm, b)[0]

    jloss, jgrads = jax.vmap(jax.value_and_grad(loss))(params, batch)
    jgrads = jax.tree.leaves(jgrads)
    pg, metrics = gradient_plane(p.loss_fn, p.state.x, p.to_device(_np(batch)), per_worker=T.split_layers)
    np.testing.assert_allclose(metrics["loss"].numpy(), np.asarray(jloss), rtol=1e-6)
    views = packing.leaf_views(pg)
    assert len(views) == len(jgrads)
    for path, got, want in zip(pg.layout.paths, views, jgrads):
        want = np.asarray(want)
        assert got.shape == want.shape, path
        for w in range(WORKERS):
            err = np.abs(got[w].numpy() - want[w]).max()
            assert err <= 1e-4 * np.abs(want[w]).max(), (path, w, err, np.abs(want[w]).max())
    for v in views:  # every leaf of every worker gets a gradient
        assert bool((v.reshape(WORKERS, -1) != 0).any(dim=1).all())


def _slotwise(got, want, layout, like=None):
    """max over the plane's leaf slots (and worker rows) of max|Δ| /
    max|like| within the slot (``like`` defaults to ``want``)."""
    got, want = np.atleast_2d(got), np.atleast_2d(want)
    like = want if like is None else np.atleast_2d(like)
    worst = 0.0
    for s in layout.slots:
        a, b = got[:, s.offset : s.offset + s.size], want[:, s.offset : s.offset + s.size]
        scale = np.abs(like[:, s.offset : s.offset + s.size]).max(axis=1)
        err = np.abs(a - b).max(axis=1)
        worst = max(worst, float(np.max(np.where(scale > 0, err / np.where(scale > 0, scale, 1), err))))
    return worst


def test_one_round_matches_jax(pair):
    """One round (two local steps and a boundary), f32: every state plane
    within 1e-4·max|slot| of the reference, leaf slot by leaf slot and
    worker by worker (observed ≤ 2.9e-6); v = mean − z against the anchor's
    scale; the losses rtol 1e-6 (observed 2.3e-7)."""
    j, p = pair
    rb = jloaders.round_batch(jloaders.lm_batch_fn(j.model_cfg, WORKERS, BATCH, SEQ, seed=3), 2)
    jstate, jms = j.step_fn(j.state, rb)
    pstate, pms = p.step_fn(interop.state_from_numpy(_np(j.state), packing.layout_of(p.params)), p.to_device(_np(rb)))
    want, got = _planes(jstate), _planes(pstate)
    layout = pstate.x.layout
    for key in want:
        if key == "step":
            assert np.array_equal(got[key], want[key])
        else:
            like = want["z0"] if key.startswith("v") else None
            assert _slotwise(got[key], want[key], layout, like) <= 1e-4, key
    np.testing.assert_allclose(pms["loss"].numpy(), np.asarray(jms["loss"]), rtol=1e-6)


def test_fit_and_evaluate_match_jax(pair):
    """A 3-round fit and ``evaluate``: losses rtol 1e-5 (observed 1.5e-7 and
    7.6e-8)."""
    j, p = pair
    jcopy, pcopy = copy.copy(j), copy.copy(p)
    jcopy.next_batch = jloaders.lm_batch_fn(j.model_cfg, WORKERS, BATCH, SEQ, seed=0)
    pcopy.next_batch = loaders.lm_batch_fn(p.model_cfg, WORKERS, BATCH, SEQ, seed=0)
    pcopy.state = interop.state_from_numpy(_np(j.state), packing.layout_of(p.params))
    jl, pl = np.asarray(jcopy.fit(rounds=3).losses), np.asarray(pcopy.fit(rounds=3).losses)
    np.testing.assert_allclose(pl, jl, rtol=1e-5)
    np.testing.assert_allclose(pcopy.evaluate(eval_batches=2)["eval_loss"], jcopy.evaluate(eval_batches=2)["eval_loss"],
                               rtol=1e-5)


def test_one_round_bf16_matches_jax():
    """bf16 parameters. The bounds of ``tests/test_torch_lm.py::
    test_one_round_bf16_matches_jax``: x, z, v and the in-flight anchor
    within one bf16 ulp of the parameter plane's largest |x| (observed
    1/16); the first momentum, which holds the round's bf16 gradients,
    within 4 of its ulps (observed 2.5); the losses rtol 1e-3 (observed
    1.1e-4). This model applies the shared block once; its gradient summed
    over several uses is held by the deeper model's tests below."""
    j, p = _pair("bfloat16")
    assert p.state.x.buffers[0].dtype == torch.bfloat16
    before, carried = _planes(j.state), _planes(p.state)
    assert all(np.array_equal(before[key], carried[key]) for key in before)
    rb = jloaders.round_batch(jloaders.lm_batch_fn(j.model_cfg, WORKERS, BATCH, SEQ, seed=3), 2)
    jstate, jms = j.step_fn(j.state, rb)
    pstate, pms = p.step_fn(p.state, p.to_device(_np(rb)))
    want, got = _planes(jstate), _planes(pstate)
    ulp = np.ldexp(np.float32(1), np.frexp(np.abs(want["x0"]).max())[1] - 8)
    mulp = np.ldexp(np.float32(1), np.frexp(np.abs(want["momentum0"]).max())[1] - 8)
    for key in want:
        lim = 0 if key == "step" else (4 * mulp if key.startswith("momentum") else ulp)
        assert np.abs(got[key] - want[key]).max() <= lim, (key, np.abs(got[key] - want[key]).max(), lim)
    np.testing.assert_allclose(pms["loss"].numpy(), np.asarray(jms["loss"]), rtol=1e-3)


# -- the deeper model: the shared block at two positions -------------------------


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def deep_pair(request):
    return request.param, _pair(request.param, DEEP)


def test_deep_state_transfer_is_bitwise(deep_pair):
    """``DEEP`` at the reduced widths: the segments as the reference's
    (mamba2 ×2, shared, mamba2 ×2, shared), the leaves in its order with
    ``seg0`` and ``seg2`` and no ``seg1`` or ``seg3``, every plane carried
    across bit for bit."""
    _, (j, p) = deep_pair
    assert T.segments(p.model_cfg) == JT.segments(j.model_cfg) == [("mamba2", 2), ("shared_attn", 1)] * 2
    want, got = _planes(j.state), _planes(p.state)
    assert sorted(want) == sorted(got) and all(np.array_equal(want[key], got[key]) for key in want)
    jleaves = jax.tree_util.tree_leaves_with_path(j.params)
    tpaths = packing.layout_of(p.params).paths
    assert [tuple(str(getattr(k, "key", k)) for k in path) for path, _ in jleaves] == [tuple(t) for t in tpaths]
    assert {t[0] for t in tpaths} == {"final_norm", "seg0", "seg2", "shared_block", "tok_emb"}


def test_deep_gradient_plane_matches_jax(deep_pair):
    """One step's gradient plane, worker by worker, every leaf non-zero;
    the shared block's gradient sums its two uses a worker step, the tied
    ``tok_emb`` the gather's and the head's. f32: each leaf within
    1e-4·max|leaf| of ``jax.grad`` (observed ≤ 1.9e-5), the loss rtol 1e-6
    (observed 7.6e-8). bf16: torch rounds to bf16 after every op and sums
    the two uses in autograd's order, XLA rounds at fusion ends, so both
    stray from the f32 gradient of the same bf16 weights (``jax.grad`` with
    the weights cast to f32), by up to 0.12 of its norm for the reference
    here. Bound, leaf by leaf and worker by worker, in the Frobenius norm:
    the port's distance from the f32 gradient at most twice the reference
    bf16's (observed ≤ 1.54; the shared block's leaves ≤ 1.12) and at most
    2^-3 of the f32 gradient's norm (observed ≤ 0.093); the loss rtol 1e-3
    (observed 1.4e-4)."""
    dtype, (j, p) = deep_pair
    cfg = j.model_cfg
    batch = jloaders.lm_batch_fn(cfg, WORKERS, BATCH, SEQ, seed=11)()
    params = jax.tree.map(lambda t: jnp.stack([t] * WORKERS), j.params)

    def grads(c, prm):
        return jax.vmap(jax.value_and_grad(lambda q, b: JT.lm_loss(c, q, b)[0]))(prm, batch)

    jloss, jgrads = grads(cfg, params)
    pg, metrics = gradient_plane(p.loss_fn, p.state.x, p.to_device(_np(batch)), per_worker=T.split_layers)
    np.testing.assert_allclose(metrics["loss"].float().numpy(), np.asarray(jloss, np.float32),
                               rtol=1e-6 if dtype == "float32" else 1e-3)
    views = packing.leaf_views(pg)
    jgrads = [np.asarray(g.astype(jnp.float32)) for g in jax.tree.leaves(jgrads)]
    assert len(views) == len(jgrads)
    for v in views:
        assert bool((v.reshape(WORKERS, -1) != 0).any(dim=1).all())
    if dtype == "float32":
        for path, got, want in zip(pg.layout.paths, views, jgrads):
            for w in range(WORKERS):
                err = np.abs(got[w].numpy() - want[w]).max()
                assert err <= 1e-4 * np.abs(want[w]).max(), (path, w, err)
        return
    f32 = dataclasses.replace(cfg, dtype="float32")
    truth = jax.tree.leaves(grads(f32, jax.tree.map(lambda t: t.astype(jnp.float32), params))[1])
    for path, got, want, exact in zip(pg.layout.paths, views, jgrads, truth):
        got, exact = got.float().numpy(), np.asarray(exact)
        for w in range(WORKERS):
            norm = np.linalg.norm(exact[w])
            port, ref = np.linalg.norm(got[w] - exact[w]), np.linalg.norm(want[w] - exact[w])
            assert port <= 2 * ref and port <= 2.0**-3 * norm, (path, w, port / norm, ref / norm)


def test_deep_one_round_matches_jax(deep_pair):
    """One round (two local steps and a boundary). f32: every state plane
    within 1e-4·max|slot| of the reference, slot by slot and worker by
    worker (observed ≤ 3.1e-5), the losses rtol 1e-6 (observed 7.5e-8).
    bf16: x, z, v and the in-flight anchor within one bf16 ulp of the
    plane's largest |x| (observed 1/16); the first momentum, which holds
    the round's bf16 gradients (held above against the f32 gradient), within
    32 of its ulps (observed 17.75; 2.5 on the one-layer model, so it grows
    with depth); the losses rtol 1e-3 (observed 3.6e-4)."""
    dtype, (j, p) = deep_pair
    rb = jloaders.round_batch(jloaders.lm_batch_fn(j.model_cfg, WORKERS, BATCH, SEQ, seed=3), 2)
    jstate, jms = j.step_fn(j.state, rb)
    pstate, pms = p.step_fn(interop.state_from_numpy(_np(j.state), packing.layout_of(p.params)), p.to_device(_np(rb)))
    want, got = _planes(jstate), _planes(pstate)
    assert np.array_equal(got["step"], want["step"])
    if dtype == "float32":
        for key in want:
            if key != "step":
                like = want["z0"] if key.startswith("v") else None
                assert _slotwise(got[key], want[key], pstate.x.layout, like) <= 1e-4, key
        np.testing.assert_allclose(pms["loss"].numpy(), np.asarray(jms["loss"]), rtol=1e-6)
        return
    ulp = np.ldexp(np.float32(1), np.frexp(np.abs(want["x0"]).max())[1] - 8)
    mulp = np.ldexp(np.float32(1), np.frexp(np.abs(want["momentum0"]).max())[1] - 8)
    for key in want:
        if key != "step":
            lim = 32 * mulp if key.startswith("momentum") else ulp
            assert np.abs(got[key] - want[key]).max() <= lim, (key, np.abs(got[key] - want[key]).max(), lim)
    np.testing.assert_allclose(pms["loss"].float().numpy(), np.asarray(jms["loss"], np.float32), rtol=1e-3)


# -- entry points and refusals ---------------------------------------------------


def test_zamba2_experiment_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the CUDA default does not raise here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Experiment(arch="zamba2-1.2b").build()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(["--arch", "zamba2-1.2b", "--rounds", "1"])


def test_train_launcher_on_cpu(capsys):
    train_cli.main(["--arch", "zamba2-1.2b", "--rounds", "2", "--device", "cpu", "--seq", "20", "--workers", "2"])
    out = capsys.readouterr().out
    assert "zamba2-1.2b-smoke" in out and "round    1  loss" in out


def test_zamba2_path_imports_no_jax():
    code = textwrap.dedent(
        f"""
        import sys
        sys.path.insert(0, {str(SRC)!r})
        sys.modules["jax"] = None
        from repro_torch.api import Experiment, TokenStream
        from repro_torch.launch import train
        exp = Experiment(arch="zamba2-1.2b", workers=2, data=TokenStream(1, 20), device="cpu")
        print(len(exp.fit(rounds=1).losses), round(exp.evaluate(eval_batches=1)["eval_loss"]))
        bad = sorted(m for m in sys.modules if m == "repro" or m.startswith("repro."))
        assert not bad, bad
        """
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[0] == "1"


def test_full_width_first_loss_is_the_random_init_expectation():
    """The first loss of zamba2-1.2b at full width (d_model 2048, vocab 32000,
    tied head) with seeded random weights, cut in depth to one mamba2 layer
    and one shared-attention position, f32, batch 4 x seq 64, weights drawn
    by the reference and carried across: the port's ``lm_loss`` within rtol
    1e-5 of the reference's, and both within 0.25 of ln 32000 + 2048·0.02²/2
    = 10.783. The final norm leaves h at RMS 1 and the tied embeddings are
    N(0, 0.02²) (``models/params.py``), so the logits are N(0, 2048·0.02²)
    and independent of the next token's embedding: E[loss] = ln V + σ²/2.
    Over 256 tokens the target logit's mean has a standard deviation of
    about 0.057, so 0.25 is more than 4σ. This is why the full zamba2's
    losses sit near 10.78, above ln V. (Observed: 10.7948 both, rtol
    1.8e-7; peak ≈ 2.3 GB of host memory.)"""
    jfull = jax_get_arch("zamba2-1.2b").model
    jcfg = dataclasses.replace(jfull, dtype="float32", num_layers=2, layer_pattern=("mamba2", "shared_attn"),
                               shared_attn_every=2)
    tcfg = dataclasses.replace(get_arch("zamba2-1.2b").model, dtype="float32", num_layers=2,
                               layer_pattern=("mamba2", "shared_attn"), shared_attn_every=2)
    assert (tcfg.d_model, tcfg.vocab_size, tcfg.tie_embeddings) == (2048, 32000, True)
    assert [k for k, _ in T.segments(tcfg)] == ["mamba2", "shared_attn"]
    jparams, _ = JT.init_model(jcfg, jax.random.PRNGKey(0))
    tparams = interop.params_from_numpy(_np(jparams))
    toks, tgts = next(jloaders.lm_batch_stream(4, 64, jcfg.vocab_size, seed=3))
    jloss = float(JT.lm_loss(jcfg, jparams, dict(tokens=jnp.asarray(toks), targets=jnp.asarray(tgts)))[0])
    del jparams
    with torch.no_grad():
        tloss = float(T.lm_loss(tcfg, tparams, dict(tokens=torch.from_numpy(toks), targets=torch.from_numpy(tgts)))[0])
    expect = np.log(32000) + 2048 * 0.02**2 / 2
    assert abs(expect - 10.783) < 1e-3
    assert abs(tloss - jloss) <= 1e-5 * abs(jloss), (tloss, jloss)
    assert abs(jloss - expect) <= 0.25 and abs(tloss - expect) <= 0.25, (jloss, tloss, expect)
