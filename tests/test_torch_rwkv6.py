"""The port's rwkv6 slice (repro_torch) against the JAX reference, on the CPU:
the WKV recurrence's plain version and its autograd, the RWKV-6 time-mix
and channel-mix, and the reduced rwkv6-7b (d_model 256, 4 heads of 32,
chunk 16) trained with Overlap-Local-SGD (τ 2, α 0.6, β 0.7, packed) and
SGD + Nesterov at the training CLI's lr 1e-2.

Both packages get the same inputs: numpy arrays from a seed, the token
stream as a numpy copy, and the reference's ``Experiment.build()`` state
carried across bit for bit by ``repro_torch.interop``. On the CPU the port
runs the plain ``wkv_chunked``; the reference's CPU route is the same chunked
form (and keeps the decay w in f32, as the port does on both devices).
Each test states its bound and, in a comment, the value observed here.
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
from repro.kernels.rwkv6_wkv import ops as jwkv_ops
from repro.kernels.paged_attn import ref as jpa_ref
from repro.kernels.rwkv6_wkv import ref as jwkv_ref
from repro.models import params as JP
from repro.models import transformer as JT
from repro.models.layers import rwkv6 as jrwkv
from repro.optim import schedules as jsched
from repro.serving import BatchedEngine as JaxEngine
from repro_torch import interop
from repro_torch.api import Experiment, TokenStream
from repro_torch.config import AlgoConfig, AttentionConfig, ModelConfig, OptimizerConfig, SSMConfig, get_arch
from repro_torch.data import loaders
from repro_torch.kernels.paged_attn import ops as pa_ops
from repro_torch.kernels.rwkv6_wkv import ops as wkv_ops
from repro_torch.kernels.rwkv6_wkv import ref as wkv_ref
from repro_torch.launch import train as train_cli
from repro_torch.models import transformer as T
from repro_torch.models.layers import rwkv6 as rwkv
from repro_torch.optim import schedules
from repro_torch.parallel import packing
from repro_torch.serving.engine import BatchedEngine
from repro_torch.serving.paged_cache import paged_supported
from repro_torch.training.train_loop import gradient_plane

SRC = Path(__file__).resolve().parents[1] / "src"
WORKERS, BATCH, SEQ, LR = 4, 2, 48, 1e-2  # seq 48: three whole chunks of 16


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


def _wkv_inputs(rng, b, s, h, n, p):
    """r, k, v, w, u as in the reference's kernel sweep (tests/test_kernels.py)."""
    return (rng.normal(size=(b, s, h, n)).astype(np.float32), rng.normal(size=(b, s, h, n)).astype(np.float32),
            rng.normal(size=(b, s, h, p)).astype(np.float32),
            (0.2 + 0.79 * rng.random(size=(b, s, h, n))).astype(np.float32),
            rng.normal(size=(h, n)).astype(np.float32))


# -- the WKV recurrence ----------------------------------------------------------


@pytest.mark.parametrize("b,s,h,n,p,chunk", [(2, 24, 3, 8, 6, 8), (1, 45, 2, 16, 16, 16), (2, 32, 4, 8, 8, 32)])
def test_wkv_plain_matches_jax(rng, b, s, h, n, p, chunk):
    """The plain ``wkv_chunked`` against JAX's: 1e-5·max|y| for y and the
    final state (observed ≤ 1.3e-6); against the reference's scan and, where
    S is a whole number of chunks, the Pallas kernel in interpret mode: the
    reference test's 5e-4 absolute (observed ≤ 1.7e-5)."""
    ins = _wkv_inputs(rng, b, s, h, n, p)
    y, st = wkv_ops.wkv(*map(torch.from_numpy, ins), chunk=chunk)
    jy, jst = jwkv_ref.wkv_chunked(*map(jnp.asarray, ins), chunk=chunk)
    assert y.shape == (b, s, h, p) and st.shape == (b, h, n, p) and st.dtype == torch.float32
    assert np.abs(y.numpy() - np.asarray(jy)).max() <= 1e-5 * np.abs(np.asarray(jy)).max()
    assert np.abs(st.numpy() - np.asarray(jst)).max() <= 1e-5 * np.abs(np.asarray(jst)).max()
    ry, rst = jwkv_ref.wkv_reference(*map(jnp.asarray, ins))
    np.testing.assert_allclose(y.numpy(), np.asarray(ry), rtol=5e-4, atol=5e-4)
    np.testing.assert_allclose(st.numpy(), np.asarray(rst), rtol=5e-3, atol=5e-3)
    py, _ = wkv_ref.wkv_reference(*map(torch.from_numpy, ins))
    np.testing.assert_allclose(py.numpy(), np.asarray(ry), rtol=5e-4, atol=5e-4)
    if s % chunk == 0:
        with jflags.force_pallas():
            iy, _ = jwkv_ops.wkv(*map(jnp.asarray, ins), chunk)
        np.testing.assert_allclose(y.numpy(), np.asarray(iy), rtol=5e-4, atol=5e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wkv_autograd_matches_jax_vjp(rng, dtype):
    """Torch autograd of the port's ``wkv`` (its CPU route) against
    ``jax.vjp`` of ``wkv_chunked``, with cotangents for y and for the final
    state; r/k/v/u in ``dtype``, w in f32. Bound, as max|Δ|/max|JAX|: f32
    1e-5 (observed ≤ 4.2e-7); bf16 2^-8 (both compute in f32 between one
    cast in and one out, but XLA and torch round the same f32 sums to bf16
    from values that differ in their last f32 bits; observed ≤ 6.1e-4)."""
    b, s, h, n, chunk = 2, 45, 2, 16, 16
    r, k, v, w, u = _wkv_inputs(rng, b, s, h, n, n)
    dy = rng.normal(size=(b, s, h, n)).astype(np.float32)
    dst = rng.normal(size=(b, h, n, n)).astype(np.float32)
    jd = jnp.dtype(dtype)
    jins = [jnp.asarray(r, jd), jnp.asarray(k, jd), jnp.asarray(v, jd), jnp.asarray(w), jnp.asarray(u, jd)]
    (jy, jst), vjp = jax.vjp(lambda *a: jwkv_ref.wkv_chunked(*a, chunk=chunk), *jins)
    jgrads = vjp((jnp.asarray(dy, jd), jnp.asarray(dst)))
    tins = [interop.params_from_numpy(np.asarray(a)).requires_grad_(True) for a in jins]
    y, st = wkv_ops.wkv(*tins, chunk=chunk)
    assert y.dtype == tins[0].dtype and st.dtype == torch.float32
    grads = torch.autograd.grad((y, st), tins, (interop.params_from_numpy(np.asarray(jnp.asarray(dy, jd))),
                                                torch.from_numpy(dst)))
    bound = 1e-5 if dtype == "float32" else 2.0**-8
    assert _rel(y.float().detach(), jnp.asarray(jy, jnp.float32)) <= bound
    assert _rel(st.detach(), jst) <= bound
    for name, got, want in zip("rkvwu", grads, jgrads):
        assert got.dtype == tins["rkvwu".index(name)].dtype, name
        assert _rel(got.float(), jnp.asarray(want, jnp.float32)) <= bound, (name, _rel(got.float(), want))


def test_wkv_decode_step_matches_jax(rng):
    """``wkv_decode_step`` token by token against the reference's, and
    against the scan: 5e-4 absolute, as the reference's own test (observed
    ≤ 1e-6)."""
    b, s, h, n, p = 1, 7, 2, 4, 4
    ins = _wkv_inputs(rng, b, s, h, n, p)
    r, k, v, w, u = map(torch.from_numpy, ins)
    jr, jk, jv, jw, ju = map(jnp.asarray, ins)
    state, jstate = torch.zeros(b, h, n, p), jnp.zeros((b, h, n, p), jnp.float32)
    ys = []
    for t in range(s):
        y, state = wkv_ops.wkv_decode_step(state, r[:, t], k[:, t], v[:, t], w[:, t], u)
        jy, jstate = jwkv_ops.wkv_decode_step(jstate, jr[:, t], jk[:, t], jv[:, t], jw[:, t], ju)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-6, atol=1e-6)
        ys.append(y)
    np.testing.assert_allclose(state.numpy(), np.asarray(jstate), rtol=1e-6, atol=1e-6)
    ry, _ = jwkv_ref.wkv_reference(jr, jk, jv, jw, ju)
    np.testing.assert_allclose(torch.stack(ys, 1).numpy(), np.asarray(ry), rtol=5e-4, atol=5e-4)


@pytest.mark.parametrize("s,chunk", [(45, 16), (100, 32), (64, 32)])
def test_wkv_states_match_jax_prefixes(rng, s, chunk):
    """``ref.wkv_states`` (the plain version of the forward's first kernel):
    the state entering chunk c equals the final state of JAX's
    ``wkv_chunked`` over the first c·L steps, and the last output its final
    state over all S (ragged S included); f32, 1e-5·max|state| (sums in
    other orders; observed ≤ 1.8e-6)."""
    b, h, n = 2, 3, 8
    r, k, v, w, u = _wkv_inputs(rng, b, s, h, n, n)
    states, final = wkv_ref.wkv_states(*map(torch.from_numpy, (k, v, w)), chunk)
    nc = -(-s // chunk)
    assert states.shape == (b * h, nc, n, n) and final.shape == (b, h, n, n)
    assert torch.equal(states[:, 0], torch.zeros(b * h, n, n))
    for c in range(1, nc + 1):
        t = min(c * chunk, s)
        _, jst = jwkv_ref.wkv_chunked(*(jnp.asarray(a[:, :t]) for a in (r, k, v, w)), jnp.asarray(u), chunk=chunk)
        got = final if c == nc else states[:, c].reshape(b, h, n, n)
        assert _rel(got, jst) <= 1e-5, (c, _rel(got, jst))


def _wkv_injected(r, k, v, w, u, delta, c, chunk):
    """The plain ``wkv_chunked`` with ``delta`` added to the state leaving
    chunk c: the chunks up to c, then the rest from that state (its decayed
    read-out r·e^cum_excl·S and its decay e^total to the final state, in
    the chunked form's own terms)."""
    t = (c + 1) * chunk
    y1, s1 = wkv_ref.wkv_chunked(r[:, :t], k[:, :t], v[:, :t], w[:, :t], u, chunk=chunk)
    s1 = s1 + delta
    if t >= r.shape[1]:
        return y1, s1
    y2, s2 = wkv_ref.wkv_chunked(r[:, t:], k[:, t:], v[:, t:], w[:, t:], u, chunk=chunk)
    logw = torch.log(torch.maximum(w[:, t:], torch.tensor(1e-30)))
    cum_excl = torch.cumsum(logw, dim=1) - logw
    y2 = y2 + torch.einsum("bshn,bhnp->bshp", r[:, t:] * torch.exp(cum_excl), s1)
    s2 = s2 + torch.exp(logw.sum(1))[..., None] * s1
    return torch.cat([y1, y2], dim=1), s2


@pytest.mark.parametrize("s,chunk", [(45, 16), (64, 32)])
def test_wkv_dstates_match_autograd(rng, s, chunk):
    """``ref.wkv_dstates`` (the plain version of the backward's first
    kernel): the cotangent of the state leaving chunk c is torch autograd of
    the plain ``wkv_chunked`` with the state injected at that boundary
    (``_wkv_injected``), under cotangents for y and the final state; f32,
    1e-5·max|D| (observed ≤ 1.2e-7). That autograd is the one
    ``test_wkv_autograd_matches_jax_vjp`` holds against ``jax.vjp``."""
    b, h, n = 2, 2, 8
    r, k, v, w, u = map(torch.from_numpy, _wkv_inputs(rng, b, s, h, n, n))
    dy = torch.from_numpy(rng.normal(size=(b, s, h, n)).astype(np.float32))
    dst = torch.from_numpy(rng.normal(size=(b, h, n, n)).astype(np.float32))
    got = wkv_ref.wkv_dstates(r, w, dy, dst, chunk)
    nc = -(-s // chunk)
    assert got.shape == (b * h, nc, n, n)
    for c in range(nc):
        delta = torch.zeros(b, h, n, n, requires_grad=True)
        y, st = _wkv_injected(r, k, v, w, u, delta, c, chunk)
        (want,) = torch.autograd.grad((y * dy).sum() + (st * dst).sum(), (delta,))
        assert _rel(got[:, c].reshape(b, h, n, n), want) <= 1e-5, (c, _rel(got[:, c].reshape(b, h, n, n), want))
    assert torch.equal(got[:, nc - 1].reshape(b, h, n, n), dst)
    assert torch.equal(wkv_ref.wkv_dstates(r, w, dy, None, chunk)[:, nc - 1], torch.zeros(b * h, n, n))


WKV_STRONG = np.array([1e-30, 1e-12, 0.5, 1.0], np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wkv_strong_decay_matches_jax(rng, dtype):
    """Strong decay: each w one of 1e-30 (the clamp, where log w = -69.08),
    1e-12, 0.5 and exactly 1, so that |cum| reaches 69·L inside a chunk.
    Every output finite; the port's ``wkv_chunked`` and its autograd held
    against JAX's ``wkv_chunked`` and ``jax.vjp``, and (f32) y and the state
    against JAX's scan ``wkv_reference``, as max|Δ|/max|JAX|. bf16: the
    existing 2^-8 (observed ≤ 1.7e-3). f32: 1e-4, the resolution of the f32
    cumsum, not the existing 1e-5: e^(cum_excl_l - cum_m) carries ulp(|cum|)
    ≈ 69·L·2^-24 (6.6e-5 at L 16) of relative error in each version, and
    JAX's cumsum (reduce_window) and torch's (accumulated in f64 on the CPU)
    round differently (observed ≤ 3.2e-5; ROADMAP Queue 3). dw is held as
    dw·w (dlog w, what reaches the model's parameters through w =
    exp(-exp(x))): dw = dlog w / w multiplies the f32 rounding of dlog w, a
    sum of O(1) terms, by up to 1e30 in both versions. At w = 1e-30 both
    take half the gradient of max(w, 1e-30), as jnp.maximum does."""
    b, s, h, n, chunk = 2, 45, 2, 16, 16
    r, k, v, _, u = _wkv_inputs(rng, b, s, h, n, n)
    w = WKV_STRONG[rng.integers(0, len(WKV_STRONG), size=(b, s, h, n))]
    dy = rng.normal(size=(b, s, h, n)).astype(np.float32)
    dst = rng.normal(size=(b, h, n, n)).astype(np.float32)
    jd = jnp.dtype(dtype)
    jins = [jnp.asarray(r, jd), jnp.asarray(k, jd), jnp.asarray(v, jd), jnp.asarray(w), jnp.asarray(u, jd)]
    (jy, jst), vjp = jax.vjp(lambda *a: jwkv_ref.wkv_chunked(*a, chunk=chunk), *jins)
    jgrads = vjp((jnp.asarray(dy, jd), jnp.asarray(dst)))
    tins = [interop.params_from_numpy(np.asarray(a)).requires_grad_(True) for a in jins]
    y, st = wkv_ops.wkv(*tins, chunk=chunk)
    grads = torch.autograd.grad((y, st), tins, (interop.params_from_numpy(np.asarray(jnp.asarray(dy, jd))),
                                                torch.from_numpy(dst)))
    assert all(bool(torch.isfinite(t).all()) for t in (y, st, *grads))
    bound = 1e-4 if dtype == "float32" else 2.0**-8
    assert _rel(y.float().detach(), jnp.asarray(jy, jnp.float32)) <= bound
    assert _rel(st.detach(), jst) <= bound
    for name, got, want in zip("rkvwu", grads, jgrads):
        got, want = got.float().numpy(), np.asarray(jnp.asarray(want, jnp.float32))
        if name == "w":
            got, want = got * w, want * w
        assert _rel(got, want) <= bound, (name, _rel(got, want))
    if dtype == "float32":
        ry, rst = jwkv_ref.wkv_reference(*map(jnp.asarray, (r, k, v, w, u)))
        assert _rel(y.detach(), ry) <= bound and _rel(st.detach(), rst) <= bound


def test_wkv_rejects_bad_inputs():
    z = torch.zeros(1, 4, 2, 8)
    with pytest.raises(ValueError, match=r"\(H, N\)"):
        wkv_ops.wkv(z, z, z, z, torch.zeros(3, 8))
    with pytest.raises(ValueError, match="B,S,H,N"):
        wkv_ops.wkv(z, z[:, :3], z, z, torch.zeros(2, 8))
    with pytest.raises(ValueError, match="chunk"):
        wkv_ops.wkv(z, z, z, z, torch.zeros(2, 8), chunk=0)


# -- the layers ------------------------------------------------------------------


def _cfgs(dtype="float32"):
    """The reduced rwkv6-7b of both packages."""
    return [dataclasses.replace(c, dtype=dtype)
            for c in (jax_get_arch("rwkv6-7b").model.reduced(), get_arch("rwkv6-7b").model.reduced())]


def test_reduced_config_equals_the_reference():
    jcfg, tcfg = _cfgs()
    assert (tcfg.d_model, tcfg.d_ff, tcfg.vocab_size, tcfg.num_layers) == (256, 896, 512, 2)
    assert tcfg.ssm == SSMConfig(kind="rwkv6", state_dim=16, num_heads=4, head_dim=32, chunk_size=16)
    assert dataclasses.asdict(tcfg.ssm) == dataclasses.asdict(jcfg.ssm)
    full = get_arch("rwkv6-7b").model
    assert (full.d_model, full.num_layers, full.d_ff, full.vocab_size, full.attention) == (4096, 32, 14336, 65536, None)
    assert dataclasses.asdict(full.ssm) == dataclasses.asdict(jax_get_arch("rwkv6-7b").model.ssm)


def test_timemix_and_channelmix_match_jax(rng):
    """One layer of the reduced config's weights (drawn by the reference,
    carried across) on seeded activations, f32: the time-mix within
    3e-5·max|out| (observed 5.5e-6: its group norm divides each 32-wide head
    row by its rms, which the first position's bonus-only rows keep small)
    and the channel-mix within 1e-5·max|out| (observed 5.5e-7)."""
    jcfg, tcfg = _cfgs()
    d = jcfg.d_model

    def init(b):
        jrwkv.init_rwkv6(b, "tm", d, jcfg.ssm)
        jrwkv.init_rwkv6_ffn(b, "cm", d, jcfg.d_ff)

    jparams, _ = JP.build(init, jax.random.PRNGKey(3), jnp.float32)
    # the decay's offset at its init (-2) gives w near 0.87; spread it so the
    # test also sees strong and weak decays
    jparams["tm"]["w0"] = jnp.asarray(rng.normal(size=jparams["tm"]["w0"].shape).astype(np.float32))
    tparams = interop.params_from_numpy(_np(jparams))
    x = rng.normal(size=(2, 40, d)).astype(np.float32)
    jy, _ = jrwkv.rwkv6_timemix_apply(jparams["tm"], jcfg.ssm, jnp.asarray(x))
    ty, _ = rwkv.rwkv6_timemix_apply(tparams["tm"], tcfg.ssm, torch.from_numpy(x))
    assert np.abs(ty.numpy() - np.asarray(jy)).max() <= 3e-5 * np.abs(np.asarray(jy)).max()
    jc, _ = jrwkv.rwkv6_channelmix_apply(jparams["tm"], jparams["cm"], jnp.asarray(x))
    tc, _ = rwkv.rwkv6_channelmix_apply(tparams["tm"], tparams["cm"], torch.from_numpy(x))
    assert np.abs(tc.numpy() - np.asarray(jc)).max() <= 1e-5 * np.abs(np.asarray(jc)).max()
    with pytest.raises(ValueError, match="one token and a cache"):
        rwkv.rwkv6_timemix_apply(tparams["tm"], tcfg.ssm, torch.from_numpy(x), mode="decode")


def _bf16_ulp(a):
    """One bf16 ulp of each element of the f32 array ``a``."""
    return np.ldexp(np.float32(1), np.frexp(np.maximum(np.abs(a), np.float32(2.0**-126)))[1] - 8)


def test_bf16_timemix_feeds_the_wkv_what_the_reference_does(rng, monkeypatch):
    """The bf16 time-mix hands the WKV what the reference's CPU route hands
    its ``wkv_chunked``: r, k, v and u in bf16, each element within one bf16
    ulp of the reference's (observed: one in 10^4 elements one ulp apart, a
    matmul's last rounding), and the decay w in f32 within 2^-16 of the
    reference's relatively (observed 3.9e-6; w rounded to bf16, as the
    reference's Pallas route does, reads 3.8e-3). The output within
    2^-6·max|y| (observed 5.2e-3)."""
    jcfg, tcfg = _cfgs("bfloat16")
    d = jcfg.d_model

    def init(b):
        jrwkv.init_rwkv6(b, "tm", d, jcfg.ssm)
        jrwkv.init_rwkv6_ffn(b, "cm", d, jcfg.d_ff)

    jparams, _ = JP.build(init, jax.random.PRNGKey(3), jnp.bfloat16)
    jparams["tm"]["w0"] = jnp.asarray(rng.normal(size=jparams["tm"]["w0"].shape), jnp.bfloat16)
    tparams = interop.params_from_numpy(_np(jparams))
    seen = {}
    jwkv, twkv = jrwkv.wkv_ref.wkv_chunked, wkv_ops.wkv

    def jrecord(r, k, v, w, u, chunk):
        seen["jax"] = (r, k, v, w, u)
        return jwkv(r, k, v, w, u, chunk=chunk)

    def trecord(r, k, v, w, u, chunk):
        seen["port"] = (r, k, v, w, u)
        return twkv(r, k, v, w, u, chunk)

    monkeypatch.setattr(jrwkv.wkv_ref, "wkv_chunked", jrecord)
    monkeypatch.setattr(wkv_ops, "wkv", trecord)
    x = rng.normal(size=(2, 40, d)).astype(np.float32)
    jy, _ = jrwkv.rwkv6_timemix_apply(jparams["tm"], jcfg.ssm, jnp.asarray(x, jnp.bfloat16))
    ty, _ = rwkv.rwkv6_timemix_apply(tparams["tm"], tcfg.ssm, torch.from_numpy(x).to(torch.bfloat16))
    assert [t.dtype for t in seen["port"]] == [torch.bfloat16] * 3 + [torch.float32, torch.bfloat16]
    for name, want, got in zip("rkvwu", seen["jax"], seen["port"]):
        want, got = np.asarray(want.astype(jnp.float32)), got.float().numpy()
        if name == "w":
            assert (np.abs(got - want) <= 2.0**-16 * want).all(), name
        else:
            assert (np.abs(got - want) <= _bf16_ulp(want)).all(), name
    jy = np.asarray(jy.astype(jnp.float32))
    assert np.abs(ty.float().numpy() - jy).max() <= 2.0**-6 * np.abs(jy).max()


# -- the reduced model -----------------------------------------------------------


def _pair(dtype="float32"):
    """A JAX LM experiment and a port LM experiment of the reduced rwkv6-7b,
    the port starting from the JAX experiment's built state."""
    jcfg, tcfg = _cfgs(dtype)
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


@pytest.mark.parametrize("vocab", [512, 65536])
def test_lm_batches_byte_identical_to_jax(vocab):
    """The reduced config's vocabulary and the full one's."""
    jcfg, tcfg = (dataclasses.replace(c, vocab_size=vocab) for c in _cfgs())
    jb, tb = jloaders.lm_batch_fn(jcfg, 3, 2, 16, seed=5), loaders.lm_batch_fn(tcfg, 3, 2, 16, seed=5)
    for _ in range(3):
        want, got = jb(), tb()
        for key in ("tokens", "targets"):
            a = np.asarray(want[key])
            assert a.dtype == got[key].dtype and a.shape == got[key].shape and a.tobytes() == got[key].tobytes()


def test_state_transfer_is_bitwise(pair):
    j, p = pair
    want, got = _planes(j.state), _planes(p.state)
    assert sorted(want) == sorted(got)
    for key in want:
        assert np.array_equal(want[key], got[key]), key
    assert p.num_params == j.num_params
    jleaves = jax.tree_util.tree_leaves_with_path(j.params)
    tpaths = packing.layout_of(p.params).paths
    assert [tuple(str(getattr(k, "key", k)) for k in path) for path, _ in jleaves] == [tuple(t) for t in tpaths]


def test_loss_and_gradient_plane_match_jax(pair):
    """The loss rtol 1e-6 (observed 1.5e-7); each leaf of one step's gradient
    plane, worker by worker, within 1e-4·max|leaf| of ``jax.grad`` (observed
    ≤ 4.7e-5), except worker 3 of this batch: 4e-3 (observed 1.1e-3). Its
    first position's group-norm rows have a mean square of 3e-5, three times
    the norm's eps (y_0 is the bonus term alone), so the norm's backward
    amplifies f32 rounding: against an f64 evaluation of the same loss, the
    reference's f32 gradient is off by 6.7e-4·max|leaf| there and the
    port's by 1.7e-3, while both are within 4e-5 on workers 0-2."""
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
        for w, bound in enumerate((1e-4, 1e-4, 1e-4, 4e-3)):
            err = np.abs(got[w].numpy() - want[w]).max()
            assert err <= bound * np.abs(want[w]).max(), (path, w, err, np.abs(want[w]).max())
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
    within 1e-3·max|slot| of the reference, leaf slot by leaf slot and worker
    by worker (observed: x 5.4e-5, momentum 1.3e-4, z 0, v 7.2e-5, the
    in-flight anchor 4.7e-5; all in worker 2, whose seed-3 gradients are ill
    conditioned like worker 3's in the gradient test above, 10-50 times the
    other workers'; the other workers ≤ 3e-5); v = mean − z against the
    anchor's scale, as it keeps the ulp of its operands, not of its small
    result; the losses rtol 1e-6 (observed 2.9e-7)."""
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
            assert _slotwise(got[key], want[key], layout, like) <= 1e-3, key
    np.testing.assert_allclose(pms["loss"].numpy(), np.asarray(jms["loss"]), rtol=1e-6)


def test_fit_and_evaluate_match_jax(pair):
    """A 3-round fit and ``evaluate``: losses rtol 1e-5 (observed ~1e-7)."""
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
    test_one_round_bf16_matches_jax`` for x, z, v and the in-flight anchor
    (within one bf16 ulp of the parameter plane's largest |x|; observed 1/8)
    and the losses (rtol 1e-3; observed 6.8e-4). The momentum, which holds
    the round's bf16 gradients, is held worker by worker in norm,
    ||Δm|| ≤ 2^-2·||m|| (observed 0.067, 0.051, 0.150, 0.048), not within the
    qwen2 test's 4 ulps (observed 10 to 32 ulps of each worker's max|m|):
    the ddlerp and time-mix chains round to bf16 at every op in torch and at
    fusion ends in XLA, and the group norm's first-position rows, whose mean
    square is near its eps, amplify that in the backward; worker 2 is the
    ill-conditioned one of this batch, and its reading moves with the order
    of torch's sums (0.150 here; the port with w rounded to bf16 reads 0.061
    on one thread and 0.532 on four). So this bound cannot see how the decay
    is typed: ``test_bf16_timemix_feeds_the_wkv_what_the_reference_does``
    pins that."""
    j, p = _pair("bfloat16")
    assert p.state.x.buffers[0].dtype == torch.bfloat16
    before, carried = _planes(j.state), _planes(p.state)
    assert all(np.array_equal(before[key], carried[key]) for key in before)
    rb = jloaders.round_batch(jloaders.lm_batch_fn(j.model_cfg, WORKERS, BATCH, SEQ, seed=3), 2)
    jstate, jms = j.step_fn(j.state, rb)
    pstate, pms = p.step_fn(p.state, p.to_device(_np(rb)))
    want, got = _planes(jstate), _planes(pstate)
    ulp = np.ldexp(np.float32(1), np.frexp(np.abs(want["x0"]).max())[1] - 8)
    for key in want:
        if key.startswith("momentum"):
            for w in range(WORKERS):
                d = got[key][w].astype(np.float64) - want[key][w]
                assert np.linalg.norm(d) <= 2.0**-2 * np.linalg.norm(want[key][w].astype(np.float64)), (key, w)
        else:
            lim = 0 if key == "step" else ulp
            assert np.abs(got[key] - want[key]).max() <= lim, (key, np.abs(got[key] - want[key]).max(), lim)
    np.testing.assert_allclose(pms["loss"].numpy(), np.asarray(jms["loss"]), rtol=1e-3)


# -- entry points and refusals ---------------------------------------------------


def test_rwkv6_experiment_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the CUDA default does not raise here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Experiment(arch="rwkv6-7b").build()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(["--arch", "rwkv6-7b", "--rounds", "1"])


def test_train_launcher_on_cpu(capsys):
    train_cli.main(["--arch", "rwkv6-7b", "--rounds", "2", "--device", "cpu", "--seq", "20", "--workers", "2"])
    out = capsys.readouterr().out
    assert "rwkv6-7b-smoke" in out and "round    1  loss" in out


def test_rwkv6_path_imports_no_jax():
    code = textwrap.dedent(
        f"""
        import sys
        sys.path.insert(0, {str(SRC)!r})
        sys.modules["jax"] = None
        from repro_torch.api import Experiment, TokenStream
        from repro_torch.launch import train
        exp = Experiment(arch="rwkv6-7b", workers=2, data=TokenStream(1, 20), device="cpu")
        print(len(exp.fit(rounds=1).losses), round(exp.evaluate(eval_batches=1)["eval_loss"]))
        bad = sorted(m for m in sys.modules if m == "repro" or m.startswith("repro."))
        assert not bad, bad
        """
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[0] == "1"


def _port_model(jcfg) -> ModelConfig:
    """A reference ModelConfig as the port's (the same fields)."""
    fields = dataclasses.asdict(jcfg)
    fields["attention"] = AttentionConfig(**fields["attention"]) if fields["attention"] else None
    fields["ssm"] = SSMConfig(**fields["ssm"]) if fields["ssm"] else None
    assert fields["moe"] is None and fields["frontend"] is None
    return ModelConfig(**fields)


def test_what_the_slice_does_not_cover_raises_with_its_roadmap_item():
    """The engine refuses to page a recurrent or hybrid arch (rwkv6; zamba2,
    whose mamba2 segments keep an O(1) state), as the reference does, and
    serves it by the dense fallback instead; it refuses a GQA group its
    decode kernel does not take (over 16) before it allocates any pool."""
    _, tcfg = _cfgs()
    assert not paged_supported(tcfg) and paged_supported(get_arch("qwen2-7b").model.reduced())
    params = T.init_model(tcfg, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="paged serving requires"):
        BatchedEngine(tcfg, params, paged=True, device="cpu")
    assert not BatchedEngine(tcfg, params, device="cpu").paged
    zamba = get_arch("zamba2-1.2b").model.reduced()
    assert not paged_supported(zamba)
    with pytest.raises(ValueError, match="paged serving requires"):
        BatchedEngine(zamba, T.init_model(zamba, torch.Generator().manual_seed(0)), paged=True, device="cpu")
    qcfg = get_arch("qwen2-7b").model.reduced()
    wide = dataclasses.replace(qcfg, attention=dataclasses.replace(qcfg.attention, num_heads=17, num_kv_heads=1))
    with pytest.raises(NotImplementedError, match="GQA group of 1..16"):
        BatchedEngine(wide, T.init_model(wide, torch.Generator().manual_seed(0)), device="cpu")


# -- paged decode at head_dim 80 (h2o-danube-1.8b) -------------------------------


@pytest.mark.parametrize("window", [None, 10])
@pytest.mark.parametrize("g", [1, 4])
def test_paged_decode_at_head_dim_80_matches_jax(rng, g, window):
    """One token per slot against the pool at h2o-danube-1.8b's head_dim 80:
    the port's decode path (on the CPU its plain version, the decode
    kernel's reference) against the reference's ``paged_attend_gqa``, f32:
    the reference's own kernel tolerance, 2e-6 (online vs two-pass softmax;
    observed ≤ 3.6e-7)."""
    s_, kv, d, page, maxp = 3, 2, 80, 8, 3
    pool_k = rng.normal(size=(s_ * maxp + 1, page, kv, d)).astype(np.float32)
    pool_v = rng.normal(size=pool_k.shape).astype(np.float32)
    pt = np.arange(1, s_ * maxp + 1, dtype=np.int32).reshape(s_, maxp)
    pt[0] = 0  # idle slot: trash page, length 0
    lens = np.asarray([0, 11, 23], np.int32)
    q = (rng.normal(size=(s_, 1, kv * g, d)) / np.sqrt(d)).astype(np.float32)
    want = jpa_ref.paged_attend_gqa(*map(jnp.asarray, (q, pool_k, pool_v, pt, lens)), window=window)
    got = pa_ops.paged_attend_gqa(*map(torch.from_numpy, (q, pool_k, pool_v, pt, lens)), window=window)
    assert got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-6, atol=2e-6)


def test_engine_at_head_dim_80_matches_jax_engine():
    """The reduced h2o-danube-1.8b with head_dim 80 (the full model's; 4
    heads over 2 KV heads, a 64-token window) served by both packages'
    engines from the reference's weights: seven requests over two slots
    with mid-run arrivals and evictions; the same greedy tokens and the
    same scheduler events."""
    jbase = jax_get_arch("h2o-danube-1.8b").model.reduced()
    jcfg = dataclasses.replace(jbase, attention=dataclasses.replace(jbase.attention, head_dim=80, num_kv_heads=2))
    tcfg = _port_model(jcfg)
    jparams, _ = JT.init_model(jcfg, jax.random.PRNGKey(0))
    tparams = interop.params_from_numpy(_np(jparams))
    rng = np.random.default_rng(42)
    trace = [(f"r{i}", rng.integers(1, jcfg.vocab_size, (int(rng.integers(3, 14)),)).astype(np.int32),
              int(rng.integers(2, 7))) for i in range(7)]

    def drive(engine):
        for rid, prompt, mn in trace[:4]:
            engine.submit(rid, prompt, mn)
        steps = 0
        while engine.sched.busy:
            engine.step()
            steps += 1
            if steps == 2:
                for rid, prompt, mn in trace[4:]:
                    engine.submit(rid, prompt, mn)
        return {k: np.asarray(v).tolist() for k, v in engine.results.items()}, list(engine.sched.events)

    kw = dict(slots=2, max_len=24, page_size=4, num_pages=7, chunk=8)
    jres, jev = drive(JaxEngine(jcfg, jparams, **kw))
    tres, tev = drive(BatchedEngine(tcfg, tparams, device="cpu", **kw))
    assert any(e[0] == "evict" for e in jev)
    assert tev == jev and tres == jres
