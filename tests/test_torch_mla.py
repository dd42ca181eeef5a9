"""The port's deepseek-v3-671b path against the JAX reference, on the CPU:
MLA (``repro_torch.models.layers.attention.mla_apply``) in every mode, the
multi-token prediction loss, the latent paged pools and K10's plain version
on them, at ``ModelConfig.reduced()`` (2 layers ``["attn", "moe"]``,
d_model 256, 4 heads, q and kv LoRA 64, no-RoPE 64 + RoPE 16 = head_dim 80,
v 64, 4 experts top-2 with the shared expert, MTP depth 1, vocab 512).

Both packages get the same inputs: the reference's weights (and its
``Experiment.build()`` state) carried across by ``repro_torch.interop``, the
same numpy activations and token streams. On the CPU the port runs the
plain versions of its kernels: K6's plain body on v zero-padded from 64 to
80 (the reference's Pallas route pads it the same way; its default route,
``mha_reference``, does not pad), K7's plain RMSNorm. Stated tolerances
and why:

* ``mla_apply`` (f32) in train, prefill, dense decode and paged decode (T
  1 and T = a chunk of 5): the output max|Δ| ≤ 1e-5·max|jax| against both
  reference routes (the online softmax of 128-key blocks against the exact
  softmax, or against the Pallas body in interpret mode; the matmuls sum
  in other orders); the caches and pools (the latent and RoPE rows) within
  1e-6·max|jax| (K7's plain RMSNorm and the projections round in other
  orders), the positions exact; the train-mode gradient (x and every MLA
  leaf) against ``jax.vjp`` within 1e-5·max|jax| each;
* ``_mtp_loss``, ``lm_loss`` and its metrics (xent, moe_aux, mtp, loss):
  rtol 1e-5; the gradient of ``lm_loss`` in every leaf (``tok_emb`` takes
  the embedding's and the MTP gather's shares, ``head`` both heads', the
  ``mtp`` scope its own) within 1e-5·max|jax| of ``jax.grad``;
* one Overlap-Local-SGD round in f32 and in bf16 with the bounds of
  ``tests/test_torch_archs.py`` (the bf16 round's momentum and losses
  within twice the reference's own bf16-to-f32 distance: the top-2
  routing flips near-tied choices, as arctic's does);
* the paged engine against the reference's engine and against the port's
  dense ``generate``: the same greedy tokens (and scheduler events);
* K10's plain version on rank-3 pools, both pools in one call and each
  alone: bitwise against the reference's ``paged_append``;
* checkpoints across packages: bitwise.
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

from repro.config import get_arch as jax_get_arch
from repro.kernels import flags as jflags
from repro.kernels.paged_attn import ref as jpa_ref
from repro.models import params as JP
from repro.models import transformer as JT
from repro.models.layers import attention as jattn
from repro.models.layers import rope as jrope
from repro.serving import paged_cache as jpaged
from repro_torch import interop
from repro_torch.config import get_arch, list_archs
from repro_torch.kernels.paged_attn import ops as pa_ops
from repro_torch.kernels.paged_attn import ref as pa_ref
from repro_torch.models import transformer as T
from repro_torch.models.layers import attention as tattn
from repro_torch.models.layers import rope as trope
from repro_torch.parallel import packing
from repro_torch.serving import paged_cache as tpaged
from repro_torch.serving.engine import BatchedEngine, generate

import test_torch_archs as archs

ARCH = "deepseek-v3-671b"
SRC = Path(__file__).resolve().parents[1] / "src"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, rel):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    err, lim = np.abs(got - want).max(), rel * max(np.abs(want).max(), 1e-30)
    assert err <= lim, (err, lim)


@pytest.fixture(scope="module")
def cfgs():
    return jax_get_arch(ARCH).model.reduced(), get_arch(ARCH).model.reduced()


@pytest.fixture(scope="module")
def model(cfgs):
    jcfg, tcfg = cfgs
    jparams, _ = JT.init_model(jcfg, jax.random.PRNGKey(0))
    return jparams, interop.params_from_numpy(_np(jparams))


@pytest.fixture(scope="module")
def layer(cfgs):
    """One MLA layer of the reduced config: the reference's weights in both packages."""
    jcfg, _ = cfgs
    b = JP.Builder(jax.random.PRNGKey(5), jnp.float32)
    jattn.init_mla(b, "attn", jcfg.d_model, jcfg.attention)
    jp = b.params["attn"]
    return jp, interop.params_from_numpy(_np(jp))


def _rope(cfg, positions):
    """cos/sin of each package from the same (S, T) int32 positions."""
    a = cfg.attention
    jc, js = jrope.rope_cos_sin(jnp.asarray(positions), a.qk_rope_head_dim, a.rope_theta)
    tc, ts = trope.rope_cos_sin(torch.from_numpy(positions), a.qk_rope_head_dim, a.rope_theta)
    return (jc, js), (tc, ts)


def _x(cfg, shape, seed):
    return np.random.default_rng(seed).normal(size=shape + (cfg.d_model,)).astype(np.float32)


# -- config, registry, model checks --------------------------------------------------


def test_config_equals_the_reference_and_is_registered(cfgs):
    j, t = jax_get_arch(ARCH).model, get_arch(ARCH).model
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert dataclasses.asdict(cfgs[0]) == dataclasses.asdict(cfgs[1])
    assert ARCH in list_archs()
    a = t.attention
    assert (a.kind, a.num_heads, a.q_lora_rank, a.kv_lora_rank, a.qk_nope_head_dim, a.qk_rope_head_dim,
            a.v_head_dim) == ("mla", 128, 1536, 512, 128, 64, 128)
    assert (t.d_model, t.vocab_size, t.d_ff, t.mtp_depth, t.moe.num_experts, t.moe.top_k) == (7168, 129280, 18432, 1,
                                                                                               256, 8)
    r = cfgs[1].attention
    assert cfgs[1].pattern() == ("attn", "moe") and r.qk_nope_head_dim + r.qk_rope_head_dim == 80 and r.v_head_dim == 64


def test_mla_and_mtp_run_and_what_still_raises(cfgs):
    """``_check_supported`` takes MLA and MTP, and since ROADMAP item 8 also
    M-RoPE (over MLA's RoPE part, ``qk_rope_head_dim``) and GELU (the dense
    layer's GELU MLP, the experts' and the shared expert's GELU gate): the
    reduced deepseek with both gives the reference's logits and loss (1e-5
    of max|ref|, rtol 1e-6, as the MLA forward); M-RoPE sections that do not
    tile qk_rope_head_dim/2 raise, as the reference's assertion does."""
    jcfg, tcfg = cfgs
    T._check_supported(tcfg)
    both = []
    for c in (jcfg, tcfg):
        c = dataclasses.replace(c, act="gelu")
        both.append(dataclasses.replace(c, attention=dataclasses.replace(c.attention, rope="mrope",
                                                                         mrope_sections=(4, 2, 2))))
    with pytest.raises(ValueError, match="must sum to 8"):
        T._check_supported(dataclasses.replace(tcfg, attention=dataclasses.replace(tcfg.attention, rope="mrope")))
    jparams, _ = JT.init_model(both[0], jax.random.PRNGKey(0))
    tparams = interop.params_from_numpy(_np(jparams))
    assert "bi" in tparams["seg0"]["ffn"]  # the dense layer's GELU MLP
    toks = np.random.default_rng(0).integers(0, jcfg.vocab_size, (2, 12)).astype(np.int32)
    batch = dict(tokens=toks, targets=np.roll(toks, -1, axis=1))
    jl, _ = JT.apply_model(both[0], jparams, dict(tokens=jnp.asarray(toks)), mode="train")
    tl, _ = T.apply_model(both[1], tparams, dict(tokens=torch.from_numpy(toks)), mode="train")
    assert np.abs(tl.numpy() - np.asarray(jl)).max() <= 1e-5 * np.abs(np.asarray(jl)).max()
    jloss, _ = JT.lm_loss(both[0], jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    tloss, tm = T.lm_loss(both[1], tparams, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert "mtp" in tm
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-6)


def test_params_match_the_reference_leaf_for_leaf(cfgs, model):
    """The same leaves, shapes and flatten order as the reference's tree, the
    MLA leaves and the unstacked ``mtp`` scope among them, and port-drawn
    weights of the same structure."""
    jcfg, tcfg = cfgs
    jparams, tparams = model
    leaves, paths = packing.tree_flatten(tparams)
    jleaves = jax.tree.leaves(jparams)
    assert [tuple(t.shape) for t in leaves] == [tuple(a.shape) for a in jleaves]
    for name in ("wdq", "wuq", "wdkv", "wuk", "wuv", "wkr", "wo"):
        assert ("seg0", "attn", name) in paths and ("mtp", "attn", name) in paths
    for name in ("q_norm", "kv_norm"):
        assert ("seg1", "attn", name, "scale") in paths
    assert ("mtp", "proj") in paths and ("mtp", "ln_in", "scale") in paths and ("mtp", "ffn", "wi_gate") in paths
    assert tparams["mtp"]["proj"].shape == (2 * tcfg.d_model, tcfg.d_model)
    drawn = T.init_model(tcfg, torch.Generator().manual_seed(0))
    assert [(p, tuple(t.shape)) for t, p in zip(*packing.tree_flatten(drawn))] == \
        [(p, tuple(t.shape)) for t, p in zip(leaves, paths)]


def test_interop_and_plane_layout_match_the_reference(cfgs, model):
    """A bf16 tree (MoE: a bf16 bucket and the f32 router's) packs into the
    same two-bucket plane in both packages, bit for bit, the MLA and
    ``mtp`` leaves included, and unpacks back to the same leaves."""
    from repro.parallel import packing as jpacking

    jparams, _ = model
    jb = jax.tree_util.tree_map_with_path(
        lambda p, a: a if "router" in jax.tree_util.keystr(p) else a.astype(jnp.bfloat16), jparams)
    tb = interop.params_from_numpy(_np(jb))
    jplane = jpacking.pack(jb, jpacking.layout_of(jb))
    layout = packing.layout_of(tb)
    assert layout.bucket_dtypes == ("bfloat16", "float32")
    tplane = interop.packed_from_numpy(_np(jplane), layout)
    ref = packing.pack(tb)
    assert all(torch.equal(a, b) for a, b in zip(tplane.buffers, ref.buffers))
    back = packing.tree_flatten(packing.unpack(tplane))[0]
    assert all(torch.equal(a, b) for a, b in zip(back, packing.tree_flatten(tb)[0]))


# -- mla_apply in every mode -----------------------------------------------------------


@pytest.mark.parametrize("route", ["mha_reference", "pallas_interpret"])
def test_mla_train_matches_jax(cfgs, layer, route):
    """Train mode against both reference routes (the Pallas one pads v to
    the q/k head dim, as the port always does)."""
    jcfg, tcfg = cfgs
    jp, tp = layer
    x = _x(jcfg, (2, 24), 1)
    pos = np.broadcast_to(np.arange(24, dtype=np.int32), (2, 24)).copy()
    (jc, js), (tc, ts) = _rope(jcfg, pos)
    if route == "pallas_interpret":
        with jflags.force_pallas():
            want, _ = jattn.mla_apply(jp, jcfg.attention, jnp.asarray(x), jc, js, mode="train")
    else:
        want, _ = jattn.mla_apply(jp, jcfg.attention, jnp.asarray(x), jc, js, mode="train")
    got, cache = tattn.mla_apply(tp, tcfg.attention, torch.from_numpy(x), tc, ts, mode="train")
    assert cache is None
    _close(got.numpy(), want, 1e-5)


def test_mla_train_gradient_matches_jax_vjp(cfgs, layer):
    jcfg, tcfg = cfgs
    jp, tp = layer
    x = _x(jcfg, (2, 20), 2)
    pos = np.broadcast_to(np.arange(20, dtype=np.int32), (2, 20)).copy()
    (jc, js), (tc, ts) = _rope(jcfg, pos)
    ct = np.random.default_rng(3).normal(size=(2, 20, jcfg.d_model)).astype(np.float32)
    _, vjp = jax.vjp(lambda p, xx: jattn.mla_apply(p, jcfg.attention, xx, jc, js, mode="train")[0], jp, jnp.asarray(x))
    jgp, jgx = vjp(jnp.asarray(ct))
    tp = jax.tree.map(lambda t: t.clone().requires_grad_(True), tp)
    tx = torch.from_numpy(x).requires_grad_(True)
    y, _ = tattn.mla_apply(tp, tcfg.attention, tx, tc, ts, mode="train")
    leaves, paths = packing.tree_flatten(tp)
    grads = torch.autograd.grad(y, [tx] + leaves, torch.from_numpy(ct))
    _close(grads[0].numpy(), jgx, 1e-5)
    jleaves, jpaths = packing.tree_flatten(_np(jgp))
    jflat = dict(zip(jpaths, jleaves))
    for g, p in zip(grads[1:], paths):
        _close(g.numpy(), jflat[p], 1e-5)


def test_mla_prefill_and_dense_decode_match_jax(cfgs, layer):
    """Prefill of 11 tokens (output and the latent cache), the cache grown to
    16, then three decode steps (output and cache each step; the port writes
    the cache in place); also ``make_decode_cache`` and ``grow_cache``."""
    jcfg, tcfg = cfgs
    jp, tp = layer
    x = _x(jcfg, (2, 14), 4)
    pos = np.broadcast_to(np.arange(14, dtype=np.int32), (2, 14)).copy()
    (jc, js), (tc, ts) = _rope(jcfg, pos)
    jy, jcache = jattn.mla_apply(jp, jcfg.attention, jnp.asarray(x[:, :11]), jc[:, :11], js[:, :11], mode="prefill")
    ty, tcache = tattn.mla_apply(tp, tcfg.attention, torch.from_numpy(x[:, :11]), tc[:, :11], ts[:, :11],
                                 mode="prefill")
    _close(ty.numpy(), jy, 1e-5)
    assert sorted(tcache) == ["ckv", "krope", "pos"] and int(tcache["pos"]) == int(jcache["pos"]) == 11
    for k in ("ckv", "krope"):
        _close(tcache[k].numpy(), jcache[k], 1e-6)
    jcache, tcache = jattn.grow_cache(jcache, 16), tattn.grow_cache(tcache, 16)
    assert tcache["ckv"].shape == (2, 16, 64) and tcache["krope"].shape == (2, 16, 16)
    for i in range(11, 14):
        jy, jcache = jattn.mla_apply(jp, jcfg.attention, jnp.asarray(x[:, i : i + 1]), jc[:, i : i + 1],
                                     js[:, i : i + 1], mode="decode", cache=jcache)
        ty, same = tattn.mla_apply(tp, tcfg.attention, torch.from_numpy(x[:, i : i + 1]), tc[:, i : i + 1],
                                   ts[:, i : i + 1], mode="decode", cache=tcache)
        assert same is tcache and int(tcache["pos"]) == int(jcache["pos"]) == i + 1
        _close(ty.numpy(), jy, 1e-5)
        for k in ("ckv", "krope"):
            _close(tcache[k].numpy(), jcache[k], 1e-6)
    jfull = jattn.make_decode_cache(3, 9, jcfg.attention, jnp.float32)
    tfull = tattn.make_decode_cache(3, 9, tcfg.attention, torch.float32)
    assert sorted(tfull) == ["ckv", "krope", "pos"] and int(tfull["pos"]) == int(jfull["pos"]) == 8
    assert all(tuple(tfull[k].shape) == jfull[k].shape for k in ("ckv", "krope"))


def _pools(cfg, num_pages, page, seed):
    rng = np.random.default_rng(seed)
    a = cfg.attention
    return [rng.normal(size=(num_pages, page, w)).astype(np.float32) for w in (a.kv_lora_rank, a.qk_rope_head_dim)]


@pytest.mark.parametrize("t", [1, 5])
def test_mla_paged_decode_matches_jax(cfgs, layer, t):
    """Paged MLA against the reference's: the latent rows appended (one K10
    call for both pools, in place) and the absorbed attention, at T 1
    (joint decode of two slots and an idle one on the trash page) and T 5 (a
    prefill chunk of one slot, in-chunk causal)."""
    jcfg, tcfg = cfgs
    jp, tp = layer
    page, maxp = 4, 4
    pt = np.asarray([[3, 5, 1, 0], [0, 0, 0, 0], [2, 4, 6, 7]], np.int32)
    lens = np.asarray([9, 0, 6], np.int32) if t == 1 else np.asarray([2, 0, 6], np.int32)
    s_ = 3
    x = _x(jcfg, (s_, t), 6)
    pos = (lens[:, None] + np.arange(t, dtype=np.int32)[None, :]).astype(np.int32)
    (jc, js), (tc, ts) = _rope(jcfg, pos)
    pools = _pools(jcfg, 8, page, 7)
    jy, jnew = jattn.mla_apply(jp, jcfg.attention, jnp.asarray(x), jc, js, mode="decode",
                               cache=dict(pool_ckv=jnp.asarray(pools[0]), pool_krope=jnp.asarray(pools[1])),
                               paged=jpaged.PagedState(jnp.asarray(pt), jnp.asarray(lens)))
    tcache = dict(pool_ckv=torch.from_numpy(pools[0].copy()), pool_krope=torch.from_numpy(pools[1].copy()))
    ty, same = tattn.mla_apply(tp, tcfg.attention, torch.from_numpy(x), tc, ts, mode="decode", cache=tcache,
                               paged=tpaged.PagedState(torch.from_numpy(pt), torch.from_numpy(lens)))
    assert same is tcache
    rows = np.asarray(jpa_ref.paged_gather(jnew["pool_ckv"], jnp.asarray(pt)))
    assert not np.array_equal(rows, np.asarray(jpa_ref.paged_gather(jnp.asarray(pools[0]), jnp.asarray(pt))))
    _close(ty.numpy(), jy, 1e-5)
    for k in ("pool_ckv", "pool_krope"):
        _close(tcache[k].numpy(), jnew[k], 1e-6)


def test_paged_attend_mla_plain_matches_jax():
    rng = np.random.default_rng(8)
    q_lat, q_rope = rng.normal(size=(2, 3, 4, 16)).astype(np.float32), rng.normal(size=(2, 3, 4, 8)).astype(np.float32)
    pools = [rng.normal(size=(6, 4, w)).astype(np.float32) for w in (16, 8)]
    pt, lens = np.asarray([[1, 2, 3], [4, 5, 0]], np.int32), np.asarray([7, 2], np.int32)
    want = jpa_ref.paged_attend_mla(*map(jnp.asarray, (q_lat, q_rope, *pools, pt, lens)), scale=0.125)
    got = pa_ops.paged_attend_mla(*map(torch.from_numpy, (q_lat, q_rope, *pools, pt, lens)), scale=0.125)
    assert got.dtype == torch.float32
    _close(got.numpy(), want, 1e-6)


# -- K10's plain version on the latent pools -------------------------------------------


def _latent_case(t, dtype=np.float32):
    """Two latent pools (widths 16 and 8), a slot whose positions clamp past
    the table's end, an idle slot on the trash page, ragged lengths."""
    rng = np.random.default_rng(9 + t)
    pools = [rng.normal(size=(10, 4, w)).astype(dtype) for w in (16, 8)]
    news = [rng.normal(size=(3, t, w)).astype(dtype) for w in (16, 8)]
    pt = np.asarray([[2, 3, 4], [0, 0, 0], [5, 6, 7]], np.int32)
    lens = np.asarray([1, 0, 11 if t < 12 else 0], np.int32)
    return pools, news, pt, lens


@pytest.mark.parametrize("t", [1, 5, 16])
def test_latent_append_plain_is_bitwise_the_reference(t):
    """Both latent pools in one ``paged_append_kv_`` call (rows of different
    widths) and each alone through ``paged_append_``: the reference's
    ``paged_append`` bit for bit, the later writer winning where tokens
    collide (the idle slot's on page 0; T 16 runs past the table's end)."""
    pools, news, pt, lens = _latent_case(t)
    want = [np.asarray(jpa_ref.paged_append(*map(jnp.asarray, (p, n, pt, lens)))) for p, n in zip(pools, news)]
    tp = [torch.from_numpy(p.copy()) for p in pools]
    got = pa_ops.paged_append_kv_(tp[0], tp[1], *map(torch.from_numpy, news), torch.from_numpy(pt),
                                  torch.from_numpy(lens))
    assert got[0] is tp[0] and got[1] is tp[1]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    for p, n, w in zip(pools, news, want):
        alone = pa_ops.paged_append_(torch.from_numpy(p.copy()), torch.from_numpy(n), torch.from_numpy(pt),
                                     torch.from_numpy(lens))
        np.testing.assert_array_equal(alone.numpy(), w)


def test_latent_append_checks():
    pools, news, pt, lens = _latent_case(1)
    tp = [torch.from_numpy(p) for p in pools]
    tn = [torch.from_numpy(n) for n in news]
    pt, lens = torch.from_numpy(pt), torch.from_numpy(lens)
    with pytest.raises(ValueError, match="must match"):  # a latent pool beside a GQA-shaped one
        pa_ops.paged_append_kv_(tp[0], tp[1][..., None], tn[0], tn[1][..., None], pt, lens)
    with pytest.raises(ValueError, match="must match"):  # rows that do not fit their pool
        pa_ops.paged_append_kv_(tp[0], tp[1], tn[0], tn[0], pt, lens)
    with pytest.raises(ValueError, match="must match"):  # pools of other page counts
        pa_ops.paged_append_kv_(tp[0], tp[1][:5], tn[0], tn[1], pt, lens)


def test_latent_pools_match_the_reference(cfgs):
    jcfg, tcfg = cfgs
    jpools = jpaged.init_paged_pools(jcfg, 9, 8)
    tpools = tpaged.init_paged_pools(tcfg, 9, 8)
    assert sorted(tpools) == sorted(jpools) == ["seg0", "seg1"]
    for key in tpools:
        assert sorted(tpools[key]) == ["pool_ckv", "pool_krope"]
        assert all(tuple(tpools[key][k].shape) == jpools[key][k].shape for k in tpools[key])
    for dtype, jd in ((torch.bfloat16, jnp.bfloat16), (torch.float32, jnp.float32)):
        assert tpaged.pool_bytes(tcfg, 9, 8, dtype) == jpaged.pool_bytes(jcfg, 9, 8, jd)
    assert tpaged.paged_supported(tcfg)
    tcaches = T.init_caches(tcfg, 2, 12)
    jcaches = JT.init_caches(jcfg, 2, 12)
    for key in tcaches:
        assert sorted(tcaches[key]) == sorted(jcaches[key])
        assert all(tuple(tcaches[key][k].shape) == jcaches[key][k].shape for k in tcaches[key])


# -- the model: logits, MTP, lm_loss, gradients ------------------------------------------------


def test_forward_logits_match_jax():
    archs.test_forward_logits_match_jax(ARCH)


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    return {k: rng.integers(0, cfg.vocab_size, (2, 24)).astype(np.int32) for k in ("tokens", "targets")}


def test_mtp_loss_and_lm_loss_match_jax(cfgs, model):
    jcfg, tcfg = cfgs
    jparams, tparams = model
    batch = _batch(jcfg)
    jb, tb = {k: jnp.asarray(v) for k, v in batch.items()}, {k: torch.from_numpy(v) for k, v in batch.items()}
    _, jaux = JT.apply_model(jcfg, jparams, jb, mode="train")
    hidden = np.array(jaux["hidden"])
    jm = JT._mtp_loss(jcfg, jparams, jb, jnp.asarray(hidden))
    tm = T._mtp_loss(tcfg, tparams, tb, torch.from_numpy(hidden))
    np.testing.assert_allclose(float(tm), float(jm), rtol=1e-5)
    jloss, jms = JT.lm_loss(jcfg, jparams, jb)
    tloss, tms = T.lm_loss(tcfg, tparams, tb)
    assert sorted(tms) == sorted(jms) == ["loss", "moe_aux", "mtp", "xent"]
    for k in jms:
        np.testing.assert_allclose(float(tms[k]), float(jms[k]), rtol=1e-5, err_msg=k)
    # the loss is xent + the router term + 0.3 * mtp, in the reference's order
    want = tms["xent"] + tcfg.moe.router_aux_weight * tms["moe_aux"] / tcfg.num_layers + 0.3 * tms["mtp"]
    assert float(tloss) == float(want)


def test_lm_loss_gradient_matches_jax_in_every_leaf(cfgs, model):
    """Every leaf's gradient within 1e-5·max|jax|: ``tok_emb`` sums the
    embedding's and the MTP gather's shares, ``head`` both heads', and the
    ``mtp`` scope (``ln_in``, ``proj``, its MLA block and dense FFN) gets its
    own; none is zero."""
    jcfg, tcfg = cfgs
    jparams, tparams = model
    batch = _batch(jcfg, 1)
    jg = jax.grad(lambda p: JT.lm_loss(jcfg, p, {k: jnp.asarray(v) for k, v in batch.items()})[0])(jparams)
    leaves, paths = packing.tree_flatten(jax.tree.map(lambda t: t.clone().requires_grad_(True), tparams))
    tp = packing.tree_unflatten(paths, leaves)
    loss, _ = T.lm_loss(tcfg, tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, leaves)
    jleaves, jpaths = packing.tree_flatten(_np(jg))
    assert jpaths == paths
    for g, w, p in zip(grads, jleaves, paths):
        assert np.abs(w).max() > 0, p
        _close(g.numpy(), w, 1e-5)
    # the MTP path reaches the shared leaves: without it their gradients differ
    no_mtp = dataclasses.replace(tcfg, mtp_depth=0)
    loss2, _ = T.lm_loss(no_mtp, tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    g2 = dict(zip(paths, torch.autograd.grad(loss2, leaves, allow_unused=True)))
    for p in (("tok_emb",), ("head",)):
        assert not torch.equal(g2[p], grads[paths.index(p)]), p


# -- training ---------------------------------------------------------------------


def test_one_round_matches_jax():
    archs.test_one_round_matches_jax(ARCH)


def test_one_round_bf16_matches_jax():
    """A bf16 bucket and the router's f32 bucket; x, z, v and in-flight within
    a bf16 ulp of max|x| of their bucket; the momentum and losses within
    twice the reference's own bf16-to-f32 distance (the top-2 routing), as
    ``tests/test_torch_archs.py`` holds arctic's."""
    j, rb, jstate, pstate, jms, pms = archs._round(ARCH, "bfloat16")
    assert pstate.x.layout.bucket_dtypes == ("bfloat16", "float32")
    archs._assert_bf16_planes_close(jstate, pstate, momentum=False)
    ref32, ms32 = archs.reference_f32_round(j, rb)
    own = archs._distance(jstate.opt.momentum, ref32.opt.momentum)
    port = archs._distance(jstate.opt.momentum, pstate.opt.momentum)
    assert 0 < port <= 2 * own, (port, own)
    own_loss = float(np.abs(np.asarray(jms["loss"]) - np.asarray(ms32["loss"])).max())
    port_loss = float(np.abs(np.asarray(jms["loss"]) - pms["loss"].numpy()).max())
    assert port_loss <= 2 * own_loss, (port_loss, own_loss)


def test_checkpoint_roundtrips_between_the_packages(tmp_path):
    """The reduced deepseek-v3 in bf16 after one reference round: the
    reference's file restores in the port bitwise, the port's (after a round
    of its own) restores in the reference bitwise, with the same keys."""
    from repro.api import Experiment as JExperiment
    from repro.api import TokenStream as JTokenStream
    from repro.checkpoint import restore as jrestore
    from repro.checkpoint import save as jsave
    from repro.config import OptimizerConfig as JOpt
    from repro.optim import schedules as jsched
    from repro_torch import checkpoint
    from repro_torch.api import Experiment, TokenStream
    from repro_torch.config import OptimizerConfig
    from repro_torch.optim import schedules

    import test_torch_checkpoint as ck

    jcfg = dataclasses.replace(jax_get_arch(ARCH).model.reduced(), dtype="bfloat16")
    tcfg = dataclasses.replace(get_arch(ARCH).model.reduced(), dtype="bfloat16")
    kw = dict(workers=2, rounds=1)
    j = JExperiment(arch=jcfg, optimizer=JOpt(name="sgd", lr=1e-2), schedule=jsched.constant(1e-2),
                    data=JTokenStream(2, 16), **kw).build()
    p = Experiment(arch=tcfg, optimizer=OptimizerConfig(name="sgd", lr=1e-2), schedule=schedules.constant(1e-2),
                   data=TokenStream(2, 16), device="cpu", **kw).build()
    layout = packing.layout_of(p.params)
    jinit = j.state
    j.fit(rounds=1)
    jpath = str(tmp_path / "ref.npz")
    jsave(jpath, j.state)
    restored = checkpoint.restore(jpath, interop.state_from_numpy(_np(jinit), layout))
    ck._assert_bitwise(restored, j.state)
    p.state = restored
    p.fit(rounds=1)
    ppath = str(tmp_path / "port.npz")
    checkpoint.save(ppath, p.state)
    back = jrestore(ppath, jinit)
    ck._assert_bitwise(p.state, back)
    with np.load(ppath) as a, np.load(jpath) as b:
        assert sorted(a.files) == sorted(b.files)


# -- serving -------------------------------------------------------------------------


def test_paged_engine_matches_jax_engine():
    archs.test_paged_engine_matches_jax_engine(ARCH)


def test_dense_generate_matches_jax():
    archs.test_dense_generate_matches_jax(ARCH)


def test_paged_engine_matches_dense_generate_token_for_token(cfgs, model):
    """The port alone: each request through the paged engine (chunked prefill
    and decode on the latent pools, absorbed attention) and through dense
    ``generate`` (K6's plain prefill with v padded, absorbed decode against
    the dense latent cache): the same greedy tokens."""
    _, tcfg = cfgs
    _, tparams = model
    rng = np.random.default_rng(11)
    prompts = [rng.integers(1, tcfg.vocab_size, (n,)).astype(np.int32) for n in (21, 6, 40)]
    eng = BatchedEngine(tcfg, tparams, slots=2, max_len=64, page_size=8, chunk=16, device="cpu")
    assert eng.paged
    for i, prompt in enumerate(prompts):
        eng.submit(f"r{i}", prompt, 7)
    res = eng.run()
    for i, prompt in enumerate(prompts):
        assert res[f"r{i}"].tolist() == generate(tcfg, tparams, prompt[None], 7)[0].tolist()


# -- launchers, no JAX -----------------------------------------------------------------


def test_launchers_take_the_arch(capsys):
    from repro_torch.launch import serve as serve_cli
    from repro_torch.launch import train as train_cli

    train_cli.main(["--arch", ARCH, "--rounds", "1", "--device", "cpu", "--seq", "16", "--workers", "2"])
    out = capsys.readouterr().out
    assert f"{ARCH}-smoke" in out and "round    0  loss" in out
    serve_cli.main(["--arch", ARCH, "--device", "cpu", "--requests", "3", "--max-new", "3"])
    out = capsys.readouterr().out
    assert "engine: paged" in out and "served 3 requests / 9 tokens" in out
    # --layers and cut(): the published widths cut in depth and experts (as --full runs on one card)
    from repro_torch.launch import cut

    full = get_arch(ARCH).model
    small = cut(full, 4, 16)
    assert small.pattern() == ("attn", "attn", "attn", "moe") and small.moe.num_experts == 16
    assert (small.d_model, small.attention, small.vocab_size) == (full.d_model, full.attention, full.vocab_size)
    with pytest.raises(ValueError, match="experts"):
        cut(full, 4, 4)  # fewer experts than top-8
    train_cli.main(["--arch", ARCH, "--rounds", "1", "--device", "cpu", "--seq", "16", "--workers", "2",
                    "--layers", "1"])
    assert "round    0  loss" in capsys.readouterr().out


def test_mla_path_imports_no_jax():
    code = textwrap.dedent(
        f"""
        import sys
        sys.path.insert(0, {str(SRC)!r})
        sys.modules["jax"] = None
        import numpy as np
        from repro_torch.api import Experiment, TokenStream
        from repro_torch.serving import BatchedEngine
        exp = Experiment(arch="{ARCH}", workers=2, data=TokenStream(1, 16), device="cpu")
        print(len(exp.fit(rounds=1).losses))
        eng = BatchedEngine(exp.model_cfg, exp.params, slots=2, max_len=32, page_size=8, device="cpu")
        eng.submit("a", np.arange(1, 9, dtype=np.int32), 3)
        print(len(eng.run()["a"]))
        bad = sorted(m for m in sys.modules if m == "repro" or m.startswith("repro."))
        assert not bad, bad
        """
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["1", "3"]
