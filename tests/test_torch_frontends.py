"""The port's modality frontends against the JAX reference, on the CPU: the
reduced qwen2-vl-7b (the qwen2 backbone with M-RoPE, sections (16, 8, 8)
over head_dim 64, and the vision frontend: 16 patch embeddings of 128
through the two-layer GELU projector, prepended to the text; the loss over
the text positions) and the reduced musicgen-large (GELU MLPs with biases,
4 heads over 4, four codebooks summed in and read out by a (K, d, V) head;
the loss over every codebook), each from ``ModelConfig.reduced()``.

Both packages get the same inputs: the reference's weights and its
``Experiment.build()`` state carried across by ``repro_torch.interop``
(``jax.random`` and ``torch.Generator`` draw different weights), numpy
tokens, image embeddings and positions. On the CPU the port runs the plain
versions of its kernels. Stated tolerances and why:

* configs and batches: equal, byte for byte;
* ``mrope_cos_sin`` (f32), with t, h and w streams that differ: within 1
  f32 ulp of 1 (2^-23) of the reference's, at the published (16, 24, 24)
  over head_dim 128 and the reduced (16, 8, 8) over 64 (the angle is the
  same f32 product of the same operands; torch's and XLA's cos and sin
  round differently); the band map itself exactly (each band's angle
  equals its own stream's RoPE angle, bitwise, within the port);
* the GELU MLP (random biases) and the projector: f32 within 1e-6 of
  max|ref| (matmuls summed in other orders), bf16 within one bf16 ulp of
  max|ref| (one rounding of the matmul output, the bias add or the GELU may
  land on the other side);
* ``apply_model`` logits and ``lm_loss`` (f32), text only, with an image,
  with an image and explicit (B, 3, S) positions, and audio: logits within
  1e-5 of max|ref| (the bound of ``test_torch_archs.py``), the loss rtol
  1e-6, the loss mask equal;
* one Overlap-Local-SGD round (τ 2, α 0.6, β 0.7, m 2): f32, the bounds
  of ``test_torch_archs.py``'s round: x, z, v and the in-flight anchor rtol
  1e-5, atol 1e-6, the momentum slot by slot within 1e-5 of the slot's
  largest |value|, the losses rtol 1e-6. Not 4 f32 ulps a slot: the
  momentum holds the round's raw gradients, summed in other orders
  (observed up to 26 ulps of a slot's largest value, 3e-6 of it; ``bk``'s
  gradient is rounding noise, as the softmax ignores a bias every key
  shares), and v = mean - z cancels to a few ulps of x. bf16: x, z, v and
  the in-flight anchor within one bf16 ulp of max|x|, the losses rtol 1e-3
  (``test_torch_lm.py``'s bf16 round), the momentum within 8 bf16 ulps of
  its own largest value, not that round's 4: one step's bf16 gradient of
  ``tok_emb``, ``head`` and the FFN differs from the reference's by 2 to 4
  ulps of its largest value, text only as with an image (so not the
  projector's rounding), and the momentum adds two steps' gradients
  (observed 4.25 ulps on qwen2-vl's ``tok_emb``, 2.5 on musicgen's);
* prefill then decode: the last logits within 1e-5 of max|ref| of the
  reference's decode, and, in each package, within the reference's own
  2e-3 relative of the full prefill (``tests/test_serving.py``);
* ``generate`` and the engine's dense fallback on qwen2-vl: the
  reference's greedy tokens; musicgen has no engine: ``generate`` and
  ``BatchedEngine`` raise a ``ValueError`` that names the codebooks;
* checkpoints: bitwise, both ways.
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

from repro.api import Experiment as JExperiment
from repro.api import TokenStream as JTokenStream
from repro.checkpoint import restore as jrestore
from repro.checkpoint import save as jsave
from repro.config import AlgoConfig as JAlgo
from repro.config import OptimizerConfig as JOpt
from repro.config import get_arch as jax_get_arch
from repro.data import loaders as jloaders
from repro.models import transformer as JT
from repro.models.layers import mlp as jmlp
from repro.models.layers import rope as jrope
from repro.optim import schedules as jsched
from repro.serving import BatchedEngine as JaxEngine
from repro.serving import engine as jengine
from repro_torch import checkpoint, interop
from repro_torch.api import Experiment, TokenStream
from repro_torch.config import AlgoConfig, OptimizerConfig, get_arch
from repro_torch.data import loaders
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.models import transformer as T
from repro_torch.models.layers import mlp, rope
from repro_torch.optim import schedules
from repro_torch.parallel import packing
from repro_torch.serving import BatchedEngine, decode_step, generate, prefill
from repro_torch.serving.engine import _grow_all

VISION, AUDIO = "qwen2-vl-7b", "musicgen-large"
ARCHS = [VISION, AUDIO]
WORKERS, BATCH, SEQ, LR = 2, 2, 24, 1e-2
SRC = Path(__file__).resolve().parents[1] / "src"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small CPU ops: torch's thread pool only contends with XLA's here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _cfgs(name, dtype="float32"):
    """The reduced config of both packages in ``dtype``."""
    return [dataclasses.replace(c, dtype=dtype) for c in (jax_get_arch(name).model.reduced(),
                                                         get_arch(name).model.reduced())]


_MODELS = {}


def _model(name, dtype="float32"):
    """(reference cfg, port cfg, reference params, port params) of the reduced
    ``name``: the reference's weights in both packages."""
    if (name, dtype) not in _MODELS:
        jcfg, tcfg = _cfgs(name, dtype)
        jparams, _ = JT.init_model(jcfg, jax.random.PRNGKey(0))
        _MODELS[name, dtype] = (jcfg, tcfg, jparams, interop.params_from_numpy(_np(jparams)))
    return _MODELS[name, dtype]


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _bf16_ulp(a) -> float:
    """One bf16 ulp of max|a| (8 significant bits)."""
    return float(np.ldexp(np.float32(1), np.frexp(np.abs(np.asarray(a, np.float32)).max())[1] - 8))


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape).astype(np.int32)


def _image(cfg, b, seed):
    fe = cfg.frontend
    return np.random.default_rng(seed).normal(size=(b, fe.tokens_per_item, fe.embed_dim)).astype(np.float32)


def _grid_positions(cfg, b, s_text):
    """M-RoPE positions as a vision-language model lays them out: the image's
    patches at t 0 and their (row, column) on a square grid, then the text at
    one position past the grid in all three streams. (B, 3, S_img + S)."""
    n = cfg.frontend.tokens_per_item
    side = int(round(n**0.5))
    idx = np.arange(n)
    img = np.stack([np.zeros(n), idx // side, idx % side])
    text = np.broadcast_to(side + np.arange(s_text), (3, s_text))
    pos = np.concatenate([img, text], axis=1).astype(np.int32)
    return np.ascontiguousarray(np.broadcast_to(pos, (b, 3, n + s_text)))


def _inputs(case, cfg, b=2, s=13):
    """(numpy inputs, their names) of a forward case: ``text``, ``image``
    (the image's embeddings before the text), ``image+positions`` (and the
    grid's M-RoPE positions), ``audio`` ((B, K, S) codebook tokens)."""
    if case == "audio":
        return dict(tokens=_tokens(cfg, (b, cfg.frontend.num_codebooks, s), 1))
    out = dict(tokens=_tokens(cfg, (b, s), 1))
    if case != "text":
        out["image_embeds"] = _image(cfg, b, 2)
    if case == "image+positions":
        out["positions"] = _grid_positions(cfg, b, s)
    return out


# -- configs, M-RoPE, the GELU MLP, the projector --------------------------------


def test_configs_equal_the_reference():
    for name in ARCHS:
        j, t = jax_get_arch(name).model, get_arch(name).model
        assert dataclasses.asdict(j) == dataclasses.asdict(t), name
        assert dataclasses.asdict(j.reduced()) == dataclasses.asdict(t.reduced()), name
    vl = get_arch(VISION).model
    assert vl.attention.mrope_sections == (16, 24, 24) and vl.reduced().attention.mrope_sections == (16, 8, 8)
    assert vl.frontend.kind == "vision" and (vl.frontend.embed_dim, vl.frontend.tokens_per_item) == (1280, 1024)
    mg = get_arch(AUDIO).model
    assert mg.act == "gelu" and mg.frontend.num_codebooks == 4 and mg.attention.num_kv_heads == 32


@pytest.mark.parametrize("head_dim,sections", [(128, (16, 24, 24)), (64, (16, 8, 8))], ids=["published", "reduced"])
def test_mrope_cos_sin_matches_jax(head_dim, sections):
    """Distinct t, h and w streams (a grid's rows and columns, a wide time
    range), so a wrong band map cannot pass."""
    rng = np.random.default_rng(0)
    pos = np.stack([rng.integers(0, 4096, (2, 57)), rng.integers(0, 64, (2, 57)), rng.integers(0, 64, (2, 57)) + 100],
                   axis=1).astype(np.int32)
    jc, js = jrope.mrope_cos_sin(jnp.asarray(pos), head_dim, 1e6, sections)
    tc, ts = rope.mrope_cos_sin(torch.from_numpy(pos), head_dim, 1e6, sections)
    assert tc.shape == (2, 57, head_dim // 2) and tc.dtype == torch.float32
    for got, want in ((tc, jc), (ts, js)):
        assert np.abs(got.numpy() - np.asarray(want)).max() <= 2.0**-23
    # each band takes its own stream: its angle is that stream's RoPE angle
    bounds = np.cumsum((0,) + sections)
    for stream in range(3):
        c, s = rope.rope_cos_sin(torch.from_numpy(pos[:, stream]), head_dim, 1e6)
        band = slice(bounds[stream], bounds[stream + 1])
        assert torch.equal(tc[..., band], c[..., band]) and torch.equal(ts[..., band], s[..., band])
    with pytest.raises(ValueError, match="sum to"):
        rope.mrope_cos_sin(torch.from_numpy(pos), head_dim, 1e6, (8, 8, 8))


def test_text_mrope_positions_equal_the_reference_and_degenerate_to_rope():
    jpos = np.asarray(jrope.text_mrope_positions(2, 9, 5))
    tpos = rope.text_mrope_positions(2, 9, 5)
    assert tpos.shape == (2, 3, 9) and tpos.dtype == torch.int32
    np.testing.assert_array_equal(tpos.numpy(), jpos)
    c, s = rope.mrope_cos_sin(tpos, 64, 1e6, (16, 8, 8))
    c0, s0 = rope.rope_cos_sin(rope.text_positions(2, 9, 5), 64, 1e6)
    assert torch.equal(c, c0) and torch.equal(s, s0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gelu_mlp_matches_jax(dtype):
    """musicgen's first FFN with random (non-zero) biases: ``wi``, ``bi``,
    the tanh GELU, ``wo``, ``bo``."""
    jcfg, tcfg, jparams, _ = _model(AUDIO, dtype)
    rng = np.random.default_rng(3)
    prm = {k: np.asarray(v[0]) for k, v in jparams["seg0"]["ffn"].items()}
    for k in ("bi", "bo"):
        prm[k] = (0.1 * rng.normal(size=prm[k].shape)).astype(prm[k].dtype)
    x = rng.normal(size=(2, 9, jcfg.d_model)).astype(np.float32)
    jp = {k: jnp.asarray(v) for k, v in prm.items()}
    want = np.asarray(jmlp.gelu_mlp(jp, jnp.asarray(x, jcfg.param_dtype)).astype(jnp.float32))
    tp = interop.params_from_numpy(prm)
    got = mlp.gelu_mlp(tp, torch.from_numpy(x).to(tcfg.param_dtype))
    assert got.dtype == tcfg.param_dtype and tuple(got.shape) == want.shape
    lim = 1e-6 * np.abs(want).max() if dtype == "float32" else _bf16_ulp(want)
    assert np.abs(got.float().numpy() - want).max() <= lim


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_projector_embedding_matches_jax(dtype):
    """qwen2-vl's ``_embed`` with an image: the f32 embeddings cast to the
    parameter dtype, ``gelu(img @ w1) @ w2``, prepended to the token rows;
    the loss mask False over the image, True over the text."""
    jcfg, tcfg, jparams, tparams = _model(VISION, dtype)
    inp = _inputs("image", jcfg)
    jx, jmask = JT._embed(jcfg, jparams, {k: jnp.asarray(v) for k, v in inp.items()})
    tx, tmask = T._embed(tcfg, tparams, {k: torch.from_numpy(v) for k, v in inp.items()})
    want = np.asarray(jx.astype(jnp.float32))
    s_img = jcfg.frontend.tokens_per_item
    assert tx.dtype == tcfg.param_dtype and tuple(tx.shape) == want.shape == (2, s_img + 13, jcfg.d_model)
    lim = 1e-6 * np.abs(want).max() if dtype == "float32" else _bf16_ulp(want)
    assert np.abs(tx.float().numpy() - want).max() <= lim
    np.testing.assert_array_equal(tx[:, s_img:].float().numpy(), want[:, s_img:])  # the token rows: a gather
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))


def test_codebook_embedding_and_head_match_jax():
    """musicgen's (K, V, d) embedding summed over k = 0 … 3 in order in the
    parameter dtype (bf16: each add rounded, bitwise the reference's), and
    the (K, d, V) head's (B, K, S, V) logits."""
    jcfg, tcfg, jparams, tparams = _model(AUDIO, "bfloat16")
    toks = _tokens(jcfg, (2, 4, 11), 4)
    jx, _ = JT._embed(jcfg, jparams, dict(tokens=jnp.asarray(toks)))
    tx, mask = T._embed(tcfg, tparams, dict(tokens=torch.from_numpy(toks)))
    assert mask is None and tx.dtype == torch.bfloat16
    np.testing.assert_array_equal(tx.float().numpy(), np.asarray(jx.astype(jnp.float32)))
    h = np.random.default_rng(5).normal(size=(2, 11, jcfg.d_model)).astype(np.float32)
    want = np.asarray(JT._head(jcfg, jparams, jnp.asarray(h, jnp.bfloat16)).astype(jnp.float32))
    got = T._head(tcfg, tparams, torch.from_numpy(h).to(torch.bfloat16))
    assert tuple(got.shape) == want.shape == (2, 4, 11, jcfg.vocab_size)
    assert np.abs(got.float().numpy() - want).max() <= _bf16_ulp(want)


# -- batches --------------------------------------------------------------------


@pytest.mark.parametrize("name", ARCHS)
def test_lm_batches_are_byte_identical(name):
    """Three steps of ``lm_batch_fn``: the same keys, dtypes, shapes and
    bytes (vision: the text streams, then ``image_embeds`` from the shared
    generator; audio: the text streams drawn and discarded, then the
    codebook tokens and targets)."""
    jcfg, tcfg = _cfgs(name)
    jf, tf = jloaders.lm_batch_fn(jcfg, 3, 2, 16, seed=5), loaders.lm_batch_fn(tcfg, 3, 2, 16, seed=5)
    want_keys = ["image_embeds", "targets", "tokens"] if name == VISION else ["targets", "tokens"]
    for _ in range(3):
        jb, tb = jf(), tf()
        assert sorted(jb) == sorted(tb) == want_keys
        for k in jb:
            a = np.asarray(jb[k])
            assert a.dtype == tb[k].dtype and a.shape == tb[k].shape and a.tobytes() == tb[k].tobytes(), k
    assert tb["tokens"].shape == ((3, 2, 16) if name == VISION else (3, 2, 4, 16))


# -- the forward and the loss ------------------------------------------------------


FORWARD = [(VISION, "text"), (VISION, "image"), (VISION, "image+positions"), (AUDIO, "audio")]


@pytest.mark.parametrize("name,case", FORWARD, ids=[c for _, c in FORWARD])
def test_forward_logits_and_loss_match_jax(name, case):
    jcfg, tcfg, jparams, tparams = _model(name)
    inp = _inputs(case, jcfg)
    jl, jaux = JT.apply_model(jcfg, jparams, {k: jnp.asarray(v) for k, v in inp.items()}, mode="train")
    tl, taux = T.apply_model(tcfg, tparams, {k: torch.from_numpy(v) for k, v in inp.items()}, mode="train")
    jl = np.asarray(jl)
    assert tuple(tl.shape) == jl.shape and bool(torch.isfinite(tl).all())
    assert _rel(tl.numpy(), jl) <= 1e-5
    if jaux["loss_mask"] is None:
        assert taux["loss_mask"] is None
    else:
        np.testing.assert_array_equal(taux["loss_mask"].numpy(), np.asarray(jaux["loss_mask"]))
    targets = _tokens(jcfg, inp["tokens"].shape, 9)
    batch = dict(inp, targets=targets)
    jloss, jm = JT.lm_loss(jcfg, jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    tloss, tm = T.lm_loss(tcfg, tparams, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert sorted(tm) == sorted(jm)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-6)


def test_vision_loss_covers_the_text_alone_and_audio_every_codebook():
    """The vision loss is the cross-entropy of the last S logits; the audio
    loss the mean over B, K and S (by the port's own logits)."""
    _, tcfg, _, tparams = _model(VISION)
    inp = {k: torch.from_numpy(v) for k, v in _inputs("image", tcfg).items()}
    targets = torch.from_numpy(_tokens(tcfg, (2, 13), 9))
    logits, _ = T.apply_model(tcfg, tparams, inp, mode="train")
    assert logits.shape[1] == 13 + tcfg.frontend.tokens_per_item
    loss, _ = T.lm_loss(tcfg, tparams, dict(inp, targets=targets))
    assert torch.equal(loss, T.softmax_xent(logits[:, -13:], targets))
    _, acfg, _, aparams = _model(AUDIO)
    toks = torch.from_numpy(_tokens(acfg, (2, 4, 13), 1))
    targets = torch.from_numpy(_tokens(acfg, (2, 4, 13), 9))
    logits, _ = T.apply_model(acfg, aparams, dict(tokens=toks), mode="train")
    per = [T.softmax_xent(logits[:, k], targets[:, k]) for k in range(4)]
    loss, _ = T.lm_loss(acfg, aparams, dict(tokens=toks, targets=targets))
    assert abs(float(loss) - float(torch.stack(per).mean())) <= 1e-6 * float(loss)


# -- one Overlap-Local-SGD round ---------------------------------------------------


def _pair(name, dtype):
    """A JAX LM experiment and a port LM experiment of one configuration, the
    port starting from the JAX experiment's built state."""
    jcfg, tcfg = _cfgs(name, dtype)
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


def _round(name, dtype):
    """(the two packages' states and metrics after one round from the same
    state, and the port's layout)."""
    j, p = _pair(name, dtype)
    before, carried = _planes(j.state), _planes(p.state)
    assert sorted(before) == sorted(carried) and all(np.array_equal(before[k], carried[k]) for k in before)
    rb = jloaders.round_batch(jloaders.lm_batch_fn(j.model_cfg, WORKERS, BATCH, SEQ, seed=3), 2)
    pstate, pms = p.step_fn(p.state, p.to_device(_np(rb)))
    jstate, jms = j.step_fn(j.state, rb)
    return jstate, pstate, jms, pms, pstate.x.layout


@pytest.mark.parametrize("name", ARCHS)
def test_one_round_matches_jax(name):
    jstate, pstate, jms, pms, layout = _round(name, "float32")
    want, got = _planes(jstate), _planes(pstate)
    paths = {p for p in layout.paths}
    if name == VISION:
        assert ("projector", "w1") in paths and ("projector", "w2") in paths
    else:
        assert ("seg0", "ffn", "bi") in paths and ("seg0", "ffn", "bo") in paths
    for k in want:
        if k.startswith("momentum"):
            for s in layout.slots:
                w, g = (a[:, s.offset : s.offset + s.size] for a in (want[k], got[k]))
                assert np.abs(g - w).max() <= 1e-5 * np.abs(w).max(), (k, layout.paths[s.index])
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(pms["loss"].numpy(), np.asarray(jms["loss"]), rtol=1e-6)
    assert sorted(pms) == sorted(jms)


@pytest.mark.parametrize("name", ARCHS)
def test_one_round_bf16_matches_jax(name):
    jstate, pstate, jms, pms, layout = _round(name, "bfloat16")
    assert layout.bucket_dtypes == ("bfloat16",)
    want, got = _planes(jstate), _planes(pstate)
    for k in want:
        lim = 0 if k == "step" else 8 * _bf16_ulp(want[k]) if k.startswith("momentum") else _bf16_ulp(want["x0"])
        assert np.abs(got[k] - want[k]).max() <= lim, (k, np.abs(got[k] - want[k]).max(), lim)
    np.testing.assert_allclose(pms["loss"].float().numpy(), np.asarray(jms["loss"], np.float32), rtol=1e-3)


# -- serving --------------------------------------------------------------------


def test_image_prefill_then_decode_matches_jax():
    """Prefill an image and 12 text tokens, grow the caches, decode the 13th
    text token at position 16 + 12 (past the image), in both packages:
    the decode logits against the reference's and against each package's
    full prefill of all 13."""
    jcfg, tcfg, jparams, tparams = _model(VISION)
    inp = _inputs("image", jcfg)
    toks, img = inp["tokens"], inp["image_embeds"]
    s_img, s = jcfg.frontend.tokens_per_item, toks.shape[1]
    pos = s_img + s - 1
    jfull, _ = jengine.prefill(jcfg, jparams, dict(tokens=jnp.asarray(toks), image_embeds=jnp.asarray(img)))
    _, jc = jengine.prefill(jcfg, jparams, dict(tokens=jnp.asarray(toks[:, :-1]), image_embeds=jnp.asarray(img)))
    jdec, _ = jengine.decode_step(jcfg, jparams, jnp.asarray(toks[:, -1:]), jengine._grow_all(jc, jcfg, s_img + s),
                                  jnp.asarray(pos, jnp.int32))
    tfull, _ = prefill(tcfg, tparams, dict(tokens=torch.from_numpy(toks), image_embeds=torch.from_numpy(img)))
    _, tc = prefill(tcfg, tparams, dict(tokens=torch.from_numpy(toks[:, :-1]), image_embeds=torch.from_numpy(img)))
    assert tc["seg0"]["k"].shape[2] == s_img + s - 1
    tdec, _ = decode_step(tcfg, tparams, torch.from_numpy(toks[:, -1:]), _grow_all(tc, tcfg, s_img + s), pos)
    assert tuple(tdec.shape) == (2, 1, jcfg.vocab_size)
    assert _rel(tfull.numpy(), np.asarray(jfull)) <= 1e-5
    assert _rel(tdec.numpy(), np.asarray(jdec)) <= 1e-5
    assert _rel(np.asarray(jdec)[:, -1], np.asarray(jfull)[:, -1]) < 2e-3
    assert _rel(tdec.numpy()[:, -1], tfull.numpy()[:, -1]) < 2e-3


def test_audio_prefill_then_decode_matches_jax():
    """The reference's ``test_audio_decode_shapes`` in both packages: prefill
    (B, K, 8) codebook tokens, then a (B, K, 1) decode step at position 8,
    against the reference's step and each package's full prefill."""
    jcfg, tcfg, jparams, tparams = _model(AUDIO)
    k = jcfg.frontend.num_codebooks
    toks = _tokens(jcfg, (2, k, 9), 6)
    jfull, _ = jengine.prefill(jcfg, jparams, dict(tokens=jnp.asarray(toks)))
    _, jc = jengine.prefill(jcfg, jparams, dict(tokens=jnp.asarray(toks[..., :-1])))
    jdec, _ = jengine.decode_step(jcfg, jparams, jnp.asarray(toks[..., -1:]), jengine._grow_all(jc, jcfg, 9),
                                  jnp.asarray(8, jnp.int32))
    tpre, tc = prefill(tcfg, tparams, dict(tokens=torch.from_numpy(toks[..., :-1])))
    assert tuple(tpre.shape) == (2, k, 8, jcfg.vocab_size)
    tdec, _ = decode_step(tcfg, tparams, torch.from_numpy(toks[..., -1:]), _grow_all(tc, tcfg, 9), 8)
    tfull, _ = prefill(tcfg, tparams, dict(tokens=torch.from_numpy(toks)))
    assert tuple(tdec.shape) == (2, k, 1, jcfg.vocab_size)
    assert _rel(tdec.numpy(), np.asarray(jdec)) <= 1e-5
    assert _rel(tdec.numpy()[:, :, -1], tfull.numpy()[:, :, -1]) < 2e-3
    assert _rel(np.asarray(jdec)[:, :, -1], np.asarray(jfull)[:, :, -1]) < 2e-3


def test_vision_generate_and_engine_match_jax():
    """qwen2-vl serves text as the reference does: ``generate`` (text M-RoPE
    positions, decode at positions past the prompt) and the engine's dense
    fallback (M-RoPE and a frontend are not paged) give the reference's
    greedy tokens."""
    jcfg, tcfg, jparams, tparams = _model(VISION)
    prompt = _tokens(jcfg, (2, 11), 7)
    want = np.asarray(jengine.generate(jcfg, jparams, jnp.asarray(prompt), max_new=6))
    assert generate(tcfg, tparams, prompt, max_new=6).tolist() == want.tolist()
    rng = np.random.default_rng(8)
    trace = [(f"r{i}", rng.integers(1, jcfg.vocab_size, (n,)).astype(np.int32), mn)
             for i, (n, mn) in enumerate(((5, 4), (17, 3), (9, 5)))]
    engines = [JaxEngine(jcfg, jparams, slots=2, max_len=32), BatchedEngine(tcfg, tparams, slots=2, max_len=32,
                                                                          device="cpu")]
    assert not engines[0].paged and not engines[1].paged
    for eng in engines:
        for rid, p, mn in trace:
            eng.submit(rid, p, mn)
    jres, tres = (eng.run() for eng in engines)
    assert {k: v.tolist() for k, v in tres.items()} == {k: np.asarray(v).tolist() for k, v in jres.items()}


def test_audio_has_no_engine_and_generate_raises():
    """Where the reference's ``generate`` and engine crash on musicgen, the
    port raises a ``ValueError`` naming the codebook path."""
    _, tcfg, _, tparams = _model(AUDIO)
    with pytest.raises(ValueError, match="codebooks"):
        generate(tcfg, tparams, _tokens(tcfg, (1, 5), 0), max_new=2)
    with pytest.raises(ValueError, match="prefill and decode_step"):
        BatchedEngine(tcfg, tparams, device="cpu")
    with pytest.raises(ValueError, match="codebooks"):
        Experiment(arch=AUDIO, workers=2, data=TokenStream(1, 8), device="cpu").serve()


# -- checkpoints, launchers, the no-JAX import --------------------------------------


@pytest.mark.parametrize("name,dtype", [(VISION, "float32"), (AUDIO, "bfloat16")])
def test_frontend_state_checkpoints_both_ways(tmp_path, name, dtype):
    """The reference's file after one round restores in the port bitwise (the
    projector, the GELU biases, the rank-3 codebook embedding and head among
    the leaves), and the port's file after a round of its own restores in
    the reference bitwise."""
    j, p = _pair(name, dtype)
    layout = packing.layout_of(p.params)
    jinit = j.state
    j.fit(rounds=1)
    jpath = str(tmp_path / "ref.npz")
    jsave(jpath, j.state)
    restored = checkpoint.restore(jpath, interop.state_from_numpy(_np(jinit), layout))
    for a, b in zip(_planes(restored).values(), _planes(j.state).values()):
        np.testing.assert_array_equal(a, b)
    shapes = {path: s.shape for path, s in zip(layout.paths, layout.slots)}
    if name == AUDIO:
        assert len(shapes[("tok_emb",)]) == 3 and len(shapes[("head",)]) == 3
    p.state = restored
    p.fit(rounds=1)
    ppath = str(tmp_path / "port.npz")
    checkpoint.save(ppath, p.state)
    back = jrestore(ppath, jinit)
    for a, b in zip(_planes(p.state).values(), _planes(back).values()):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ARCHS)
def test_train_launcher_and_experiment_on_cpu(capsys, name):
    train_cli.main(["--arch", name, "--rounds", "2", "--device", "cpu", "--seq", "16", "--workers", "2"])
    out = capsys.readouterr().out
    assert f"{name}-smoke" in out and "round    1  loss" in out
    exp = Experiment(arch=name, workers=2, data=TokenStream(1, 16), device="cpu")
    res = exp.fit(rounds=1)
    ev = exp.evaluate(eval_batches=1)["eval_loss"]
    assert np.isfinite(res.losses).all() and np.isfinite(ev)


def test_serve_launcher_on_cpu(capsys):
    serve_cli.main(["--arch", VISION, "--requests", "2", "--max-new", "3", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "engine: dense fallback" in out and "served 2 requests / 6 tokens" in out
    with pytest.raises(ValueError, match="codebooks"):
        serve_cli.main(["--arch", AUDIO, "--requests", "1", "--max-new", "2", "--device", "cpu"])


def test_frontend_path_imports_no_jax():
    code = textwrap.dedent(
        f"""
        import sys
        sys.path.insert(0, {str(SRC)!r})
        sys.modules["jax"] = None
        import numpy as np
        import torch
        from repro_torch.api import Experiment, TokenStream
        from repro_torch.serving import decode_step, generate, prefill
        from repro_torch.serving.engine import _grow_all
        for arch in ("qwen2-vl-7b", "musicgen-large"):
            exp = Experiment(arch=arch, workers=2, data=TokenStream(1, 8), device="cpu")
            print(len(exp.fit(rounds=1).losses), round(exp.evaluate(eval_batches=1)["eval_loss"]))
        cfg = exp.model_cfg
        toks = torch.zeros((1, 4, 5), dtype=torch.int32)
        _, caches = prefill(cfg, exp.consensus(), dict(tokens=toks))
        logits, _ = decode_step(cfg, exp.consensus(), toks[..., -1:], _grow_all(caches, cfg, 6), 5)
        print(tuple(logits.shape))
        bad = sorted(m for m in sys.modules if m == "repro" or m.startswith("repro."))
        assert not bad, bad
        """
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "(1, 4, 1, 512)" in out.stdout
