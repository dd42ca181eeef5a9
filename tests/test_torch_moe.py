"""The port's MoE FFN (``repro_torch.models.layers.moe``) against the
reference's ``repro.models.layers.moe``, on the CPU, from the same weights
(``jax.random`` draws them; ``repro_torch.interop`` carries them across).

Both routers: arctic's softmax router with its dense residual FFN (the
reduced arctic-480b's MoE: 4 experts, top-2), and DeepSeek's sigmoid router
with normalised gates and one shared expert, also on a GQA block (the
reduced arctic with that MoE in place of its own). Stated tolerances and
why:

* the routing indices (top-k, including the order of each token's k) and
  the counts behind ``load`` and ``dropped`` (assignments an expert, kept
  assignments): exact; ``load``, ``dropped``, ``mean_prob`` and
  ``aux_loss`` themselves rtol 1e-6 (f32 means of those counts and of the
  probabilities, divided and scaled in another order: observed one ulp);
* the output (f32): max|Δ| ≤ 1e-5·max|jax| (the expert matmuls sum in other
  orders); with capacity below demand (drops) the same;
* the gradient of a random cotangent against ``jax.vjp`` (x and every
  parameter, f32): each within 1e-5·max|jax|;
* a model-level forward and one Overlap-Local-SGD round of the GQA block
  with the sigmoid router: the bounds of ``tests/test_torch_archs.py``;
* the reduced arctic in bf16 (a bf16 bucket and the router's f32 bucket):
  one round, one optimizer step and one boundary call a bucket a step or a
  round, the router's bucket f32 throughout, and the bounds of
  ``tests/test_torch_archs.py::test_one_round_bf16_matches_jax``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import MoEConfig as JMoE
from repro.config import get_arch as jax_get_arch
from repro.models import params as JP
from repro.models import transformer as JT
from repro.models.layers import moe as jmoe
from repro_torch import interop
from repro_torch.config import MoEConfig, get_arch
from repro_torch.models import transformer as T
from repro_torch.models.layers import moe

import test_torch_archs as archs

D, B, S = 64, 2, 24


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ROUTERS = {
    "softmax+dense_residual": dict(num_experts=4, top_k=2, expert_ff=48, dense_residual_ff=40),
    "sigmoid+shared": dict(num_experts=8, top_k=3, expert_ff=32, num_shared_experts=1, shared_expert_ff=40),
}


def _layer(router, capacity_factor=1.25):
    """The MoE layer of both packages and the reference's weights (f32)."""
    kw = dict(ROUTERS[router], capacity_factor=capacity_factor)
    jcfg, tcfg = JMoE(**kw), MoEConfig(**kw)
    b = JP.Builder(jax.random.PRNGKey(3), jnp.float32)
    jmoe.init_moe(b, "ffn", D, jcfg)
    jparams = b.params["ffn"]
    # a wider router than init's 0.02, so the routing is far from uniform
    jparams = dict(jparams, router=jparams["router"] * 25.0)
    return jcfg, tcfg, jparams, interop.params_from_numpy(jax.tree.map(np.asarray, jparams))


def _x(seed=0):
    return np.random.default_rng(seed).normal(size=(B, S, D)).astype(np.float32)


def _ref_idx(jparams, jcfg, x):
    """The reference's routing (``moe_apply``'s own ops up to its top-k)."""
    logits = jnp.asarray(x).reshape(-1, D).astype(jnp.float32) @ jparams["router"]
    scores = jax.nn.sigmoid(logits) if jcfg.num_shared_experts else jax.nn.softmax(logits, axis=-1)
    return np.asarray(jax.lax.top_k(scores, jcfg.top_k)[1])


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5, 4.0], ids=["train", "drops", "serving"])
@pytest.mark.parametrize("router", sorted(ROUTERS))
def test_moe_apply_matches_jax(router, capacity_factor):
    jcfg, tcfg, jparams, tparams = _layer(router)
    x = _x()
    jout, jstats = jmoe.moe_apply(jparams, jcfg, jnp.asarray(x), capacity_factor=capacity_factor)
    tout, tstats = moe.moe_apply(tparams, tcfg, torch.from_numpy(x), capacity_factor=capacity_factor)
    _, _, idx = moe.route(tparams, tcfg, torch.from_numpy(x).reshape(-1, D))
    np.testing.assert_array_equal(idx.numpy(), _ref_idx(jparams, jcfg, x))
    jout = np.asarray(jout)
    assert tout.shape == jout.shape == x.shape
    assert np.abs(tout.numpy() - jout).max() <= 1e-5 * np.abs(jout).max()
    t = B * S
    for key, counts in (("load", t * tcfg.top_k / tcfg.num_experts), ("dropped", t * tcfg.top_k)):
        got, want = tstats[key].numpy(), np.asarray(jstats[key])
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
        np.testing.assert_array_equal(np.rint(got * counts), np.rint(want * counts))
    np.testing.assert_allclose(tstats["mean_prob"].numpy(), np.asarray(jstats["mean_prob"]), rtol=1e-6)
    np.testing.assert_allclose(float(tstats["aux_loss"]), float(jstats["aux_loss"]), rtol=1e-6)
    want_cap = min(int(max(tcfg.top_k, round(t * tcfg.top_k / tcfg.num_experts * capacity_factor))), t)
    assert moe.capacity_of(t, tcfg, capacity_factor) == want_cap
    dropped = float(tstats["dropped"])
    if capacity_factor == 0.5:  # capacity below demand
        assert dropped > 0
    elif capacity_factor == 4.0:  # serving's factor: a buffer holds every token
        assert dropped == 0


@pytest.mark.parametrize("router", sorted(ROUTERS))
def test_moe_gradient_matches_jax_vjp(router):
    jcfg, tcfg, jparams, tparams = _layer(router, capacity_factor=0.75)
    x = _x(1)
    ct = np.random.default_rng(2).normal(size=x.shape).astype(np.float32)
    jout, vjp = jax.vjp(lambda p, xx: jmoe.moe_apply(p, jcfg, xx)[0], jparams, jnp.asarray(x))
    jgp, jgx = vjp(jnp.asarray(ct))
    leaves, paths = [], []
    for path, leaf in zip(*_flat(tparams)):
        leaves.append(leaf.requires_grad_(True))
        paths.append(path)
    tx = torch.from_numpy(x).requires_grad_(True)
    tree = _unflat(paths, leaves)
    tout, stats = moe.moe_apply(tree, tcfg, tx)
    assert float(stats["dropped"]) > 0
    grads = torch.autograd.grad(tout, leaves + [tx], torch.from_numpy(ct))
    want = dict(zip(_flat(jax.tree.map(np.asarray, jgp))[0], _flat(jax.tree.map(np.asarray, jgp))[1]))
    for path, g in zip(paths, grads[:-1]):
        w = want[path]
        assert np.abs(g.numpy() - w).max() <= 1e-5 * np.abs(w).max(), path
    jgx = np.asarray(jgx)
    assert np.abs(grads[-1].numpy() - jgx).max() <= 1e-5 * np.abs(jgx).max()


def _flat(tree, prefix=()):
    """(paths, leaves) of a nested dict in sorted-key order."""
    if isinstance(tree, dict):
        paths, leaves = [], []
        for k in sorted(tree):
            p, lv = _flat(tree[k], prefix + (k,))
            paths += p
            leaves += lv
        return paths, leaves
    return [prefix], [tree]


def _unflat(paths, leaves):
    out = {}
    for p, leaf in zip(paths, leaves):
        node = out
        for k in p[:-1]:
            node = node.setdefault(k, {})
        node[p[-1]] = leaf
    return out


# -- the sigmoid router on a GQA block ------------------------------------------------------


def _sigmoid_cfgs(dtype="float32"):
    """The reduced arctic with DeepSeek's routing in place of its own: 4
    experts top-2, a sigmoid router with normalised gates and one shared
    expert, no dense residual."""
    kw = dict(num_experts=4, top_k=2, expert_ff=32, num_shared_experts=1, shared_expert_ff=48)
    out = []
    for cfg, cls in ((jax_get_arch("arctic-480b").model.reduced(), JMoE),
                     (get_arch("arctic-480b").model.reduced(), MoEConfig)):
        out.append(dataclasses.replace(cfg, moe=cls(**kw), dtype=dtype, name="gqa-sigmoid-moe-smoke"))
    return out


def test_sigmoid_router_gqa_block_forward_and_round_match_jax(monkeypatch):
    jcfg, tcfg = _sigmoid_cfgs()
    monkeypatch.setattr(archs, "_cfgs", lambda case, dtype="float32": _sigmoid_cfgs(dtype))
    jparams, _ = JT.init_model(jcfg, jax.random.PRNGKey(0))
    tparams = interop.params_from_numpy(jax.tree.map(np.asarray, jparams))
    assert "shared" in tparams["seg0"]["ffn"] and "dense_residual" not in tparams["seg0"]["ffn"]
    toks = np.random.default_rng(0).integers(0, jcfg.vocab_size, (2, 40)).astype(np.int32)
    jl, jaux = JT.apply_model(jcfg, jparams, dict(tokens=jnp.asarray(toks)), mode="train")
    tl, taux = T.apply_model(tcfg, tparams, dict(tokens=torch.from_numpy(toks)), mode="train")
    jl = np.asarray(jl)
    assert np.abs(tl.numpy() - jl).max() <= 1e-5 * np.abs(jl).max()
    np.testing.assert_allclose(float(taux["moe_aux"]), float(jaux["moe_aux"]), rtol=1e-5)
    archs.test_one_round_matches_jax("sigmoid")


# -- the reduced arctic on a bf16 + f32 plane -------------------------------------------------


def test_arctic_bf16_round_one_call_a_bucket(monkeypatch):
    """One round of the reduced arctic in bf16: the plane has a bf16 bucket
    and the router's f32 bucket; the optimizer step and the boundary run
    once a bucket (a step, a round), and the round agrees with the
    reference's under ``test_torch_archs.py``'s bf16 bounds."""
    from repro_torch.core import strategy
    from repro_torch.optim import optimizers

    calls = {"sgd_step": [], "pullback": []}
    sgd, pull = optimizers.opt_ops.sgd_step, strategy.anchor_ops.pullback_mean_momentum

    def sgd_counted(x, *a, **kw):
        calls["sgd_step"].append(x.dtype)
        return sgd(x, *a, **kw)

    def pull_counted(x, *a, **kw):
        calls["pullback"].append(x.dtype)
        return pull(x, *a, **kw)

    monkeypatch.setattr(optimizers.opt_ops, "sgd_step", sgd_counted)
    monkeypatch.setattr(strategy.anchor_ops, "pullback_mean_momentum", pull_counted)
    archs.test_one_round_bf16_matches_jax("arctic-480b")
    both = [torch.bfloat16, torch.float32]
    assert calls == {"sgd_step": both * 2, "pullback": both}
    _, p = archs._pair("arctic-480b", "bfloat16")
    layout = p.state.x.layout
    assert layout.bucket_dtypes == ("bfloat16", "float32")
    f32 = [layout.paths[s.index] for s in layout.slots if s.bucket == 1]
    assert f32 == [("seg0", "ffn", "router")]
    assert p.params["seg0"]["ffn"]["router"].dtype == torch.float32
    cfg = p.model_cfg
    assert p.params["seg0"]["ffn"]["wi_gate"].shape == (cfg.num_layers, cfg.moe.num_experts, cfg.d_model,
                                                        cfg.moe.expert_ff)
