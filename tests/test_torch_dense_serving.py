"""The port's dense serving path (repro_torch.serving: ``prefill``,
``decode_step``, ``generate``, the dense ``BatchedEngine`` fallback, serving
off a plane, ``swap_plane``, ``hot_swap``) against the JAX reference, on the
CPU. Counterparts of tests/test_serving.py, test_serving_sched.py's plane
swaps and test_fault.py's hot_swap test.

The reference builds the weights of the reduced qwen2-7b, rwkv6-7b and
zamba2-1.2b in f32 (``T.init_model``); they cross to the port with
``repro_torch.interop``, and both packages run the same seeded numpy
tokens. Stated tolerances, as max|port − reference| / max|reference|:
logits and every float cache leaf 1e-5 (the two packages' matmuls sum in
other orders; observed ≤ 1.6e-6), rwkv6 3e-5 (its WKV's chunked sums too,
the bound of test_torch_rwkv6.py's time-mix; observed ≤ 7.6e-6); integer
cache leaves (``positions``, ``pos``) exact. Greedy tokens exact.
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
from repro.models import transformer as JT
from repro.parallel import packing as jpacking
from repro.serving import BatchedEngine as JaxEngine
from repro.serving import engine as je
from repro_torch import checkpoint, interop
from repro_torch.config import get_arch
from repro_torch.models import transformer as T
from repro_torch.parallel import packing
from repro_torch.serving import BatchedEngine, decode_step, generate, hot_swap, prefill
from repro_torch.serving import engine as te
from repro_torch.serving.paged_cache import paged_supported

SRC = Path(__file__).resolve().parents[1] / "src"
ARCHS = ["qwen2-7b", "rwkv6-7b", "zamba2-1.2b"]
TOL = {"qwen2-7b": 1e-5, "rwkv6-7b": 3e-5, "zamba2-1.2b": 1e-5}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


_MODELS = {}


def _model(arch, **attention):
    """(reference cfg, port cfg, reference params, port params): the reduced
    ``arch`` in f32, the reference's weights in both."""
    key = (arch, tuple(sorted(attention.items())))
    if key not in _MODELS:
        cfgs = [dataclasses.replace(c, dtype="float32")
                for c in (jax_get_arch(arch).model.reduced(), get_arch(arch).model.reduced())]
        if attention:
            cfgs = [dataclasses.replace(c, attention=dataclasses.replace(c.attention, **attention)) for c in cfgs]
        jparams, _ = JT.init_model(cfgs[0], jax.random.PRNGKey(0))
        _MODELS[key] = (*cfgs, jparams, interop.params_from_numpy(_np(jparams)))
    return _MODELS[key]


def _compare_caches(tcache, jcache, tol):
    flat = jax.tree_util.tree_flatten_with_path(jcache)[0]
    n = 0
    for path, leaf in flat:
        node = tcache
        for p in path:
            node = node[p.key]
        leaf = np.asarray(leaf)
        name = "/".join(p.key for p in path)
        assert tuple(node.shape) == leaf.shape, name
        assert str(node.dtype).split(".")[-1] == leaf.dtype.name, name
        if leaf.dtype.kind == "i":
            np.testing.assert_array_equal(node.numpy(), leaf, err_msg=name)
        else:
            assert _rel(node.numpy(), leaf) <= tol, (name, _rel(node.numpy(), leaf))
        n += 1
    assert n == len(packing.tree_flatten(tcache)[0])


# -- prefill, decode_step, generate ------------------------------------------------


@pytest.mark.parametrize("s", [2, 12, 37])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_and_caches_match_jax(arch, s, rng):
    """S 2 (shorter than the mamba2 conv window's 3 rows), 12 (below one
    chunk of 16) and 37 (a ragged last chunk)."""
    jcfg, tcfg, jparams, tparams = _model(arch)
    toks = rng.integers(0, jcfg.vocab_size, (2, s)).astype(np.int32)
    jl, jcache = je.prefill(jcfg, jparams, dict(tokens=jnp.asarray(toks)))
    tl, tcache = prefill(tcfg, tparams, dict(tokens=torch.from_numpy(toks)))
    assert tl.shape == (2, s, tcfg.vocab_size) and not tl.requires_grad
    assert _rel(tl.numpy(), jl) <= TOL[arch]
    _compare_caches(tcache, jcache, TOL[arch])


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_after_grow_match_jax(arch, rng):
    """Prefill 11 tokens, grow every attention cache, then three decode steps:
    logits and every cache leaf after each step."""
    jcfg, tcfg, jparams, tparams = _model(arch)
    s, n = 11, 3
    toks = rng.integers(0, jcfg.vocab_size, (2, s + n)).astype(np.int32)
    _, jcache = je.prefill(jcfg, jparams, dict(tokens=jnp.asarray(toks[:, :s])))
    _, tcache = prefill(tcfg, tparams, dict(tokens=torch.from_numpy(toks[:, :s])))
    jcache, tcache = je._grow_all(jcache, jcfg, s + n), te._grow_all(tcache, tcfg, s + n)
    _compare_caches(tcache, jcache, TOL[arch])
    for i in range(n):
        jl, jcache = je.decode_step(jcfg, jparams, jnp.asarray(toks[:, s + i : s + i + 1]), jcache,
                                    jnp.asarray(s + i, jnp.int32))
        tl, tcache = decode_step(tcfg, tparams, torch.from_numpy(toks[:, s + i : s + i + 1]), tcache, s + i)
        assert tl.shape == (2, 1, tcfg.vocab_size)
        assert _rel(tl.numpy(), jl) <= TOL[arch], i
        _compare_caches(tcache, jcache, TOL[arch])


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_prefill(arch, rng):
    """The reference's test_decode_matches_prefill within the port: decode of
    the last token after a prefill of the rest gives the full prefill's last
    logits, within its 2e-3 relative bound."""
    _, tcfg, _, tparams = _model(arch)
    b, s = 2, 12
    toks = torch.from_numpy(rng.integers(0, tcfg.vocab_size, (b, s)).astype(np.int32))
    full, _ = prefill(tcfg, tparams, dict(tokens=toks))
    _, caches = prefill(tcfg, tparams, dict(tokens=toks[:, : s - 1]))
    caches = te._grow_all(caches, tcfg, s)
    dec, _ = decode_step(tcfg, tparams, toks[:, s - 1 :], caches, torch.tensor(s - 1, dtype=torch.int32))
    assert _rel(dec[:, -1].numpy(), full[:, -1].numpy()) < 2e-3


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_greedy_tokens_match_jax(arch, rng):
    jcfg, tcfg, jparams, tparams = _model(arch)
    prompt = rng.integers(0, jcfg.vocab_size, (2, 7)).astype(np.int32)
    want = np.asarray(je.generate(jcfg, jparams, jnp.asarray(prompt), max_new=6))
    got = generate(tcfg, tparams, prompt, max_new=6)
    assert got.dtype == np.int32 and got.shape == (2, 6)
    np.testing.assert_array_equal(got, want)
    # a tensor prompt, and a teacher-forced forward reproduces the argmax chain
    assert generate(tcfg, tparams, torch.from_numpy(prompt), 6).tolist() == got.tolist()
    seq = torch.from_numpy(np.concatenate([prompt, got], axis=1))
    logits, _ = T.apply_model(tcfg, tparams, dict(tokens=seq), mode="train")
    np.testing.assert_array_equal(torch.argmax(logits[:, 6:12], dim=-1).numpy(), got)


def test_sliding_window_ring_buffer_generation(rng):
    """The reference's ring-buffer test: qwen2 with sliding_window 8 generates
    past the window; the ring buffer holds the last 8 positions, the tokens
    equal the reference's and a teacher-forced forward's argmax chain."""
    jcfg, tcfg, jparams, tparams = _model("qwen2-7b", sliding_window=8)
    prompt = rng.integers(0, jcfg.vocab_size, (1, 6)).astype(np.int32)
    got = generate(tcfg, tparams, prompt, max_new=10)
    np.testing.assert_array_equal(got, np.asarray(je.generate(jcfg, jparams, jnp.asarray(prompt), max_new=10)))
    seq = torch.from_numpy(np.concatenate([prompt, got], axis=1))
    logits, _ = T.apply_model(tcfg, tparams, dict(tokens=seq), mode="train")
    np.testing.assert_array_equal(torch.argmax(logits[0, 5:15], dim=-1).numpy(), got[0])
    # a prefill longer than the window keeps the last 8 positions
    _, caches = prefill(tcfg, tparams, dict(tokens=seq[:, :13]))
    assert caches["seg0"]["k"].shape[2] == 8
    assert caches["seg0"]["positions"][0].tolist() == list(range(5, 13))


def test_sampled_generation_is_seeded_and_in_vocab(rng):
    _, tcfg, _, tparams = _model("rwkv6-7b")
    prompt = rng.integers(0, tcfg.vocab_size, (2, 5)).astype(np.int32)
    a = generate(tcfg, tparams, prompt, 8, temperature=0.8, seed=3)
    assert a.tolist() == generate(tcfg, tparams, prompt, 8, temperature=0.8, seed=3).tolist()
    assert a.tolist() != generate(tcfg, tparams, prompt, 8, temperature=0.8, seed=4).tolist()
    assert a.min() >= 0 and a.max() < tcfg.vocab_size


def test_generate_guards():
    with pytest.raises(ValueError, match="empty"):
        generate(None, None, np.zeros((0, 4), np.int32), 4)
    with pytest.raises(ValueError, match="batch, seq"):
        generate(None, None, np.zeros((4,), np.int32), 4)
    with pytest.raises(ValueError, match="max_new"):
        generate(None, None, np.ones((1, 4), np.int32), 0)


def test_init_caches_warm_ring_matches_jax():
    jcfg, tcfg, _, _ = _model("zamba2-1.2b")
    want = JT.init_caches(jcfg, 2, 20)
    got = T.init_caches(tcfg, 2, 20)
    _compare_caches(got, want, 0.0)
    for arch in ("qwen2-7b", "rwkv6-7b"):
        jcfg, tcfg, _, _ = _model(arch)
        _compare_caches(T.init_caches(tcfg, 1, 9), JT.init_caches(jcfg, 1, 9), 0.0)


# -- the engine ----------------------------------------------------------------------


def _trace(rng, n, vmax, lp, mn):
    return [(f"r{i}", rng.integers(1, vmax, (int(rng.integers(*lp)),)).astype(np.int32), int(rng.integers(*mn)))
            for i in range(n)]


@pytest.mark.parametrize("arch", ARCHS)
def test_batched_engine_matches_jax_engine(arch):
    """Each family through both engines (paged="auto": qwen2 paged, rwkv6
    and zamba2 the dense fallback): the same tokens per request, a stop token
    cutting one short."""
    jcfg, tcfg, jparams, tparams = _model(arch)
    trace = _trace(np.random.default_rng(11), 3, jcfg.vocab_size, lp=(3, 9), mn=(2, 5))
    kw = dict(slots=2, max_len=24, page_size=4)
    jeng, teng = JaxEngine(jcfg, jparams, **kw), BatchedEngine(tcfg, tparams, device="cpu", **kw)
    assert teng.paged == jeng.paged == (arch == "qwen2-7b")
    for eng in (jeng, teng):
        for rid, prompt, mn in trace:
            eng.submit(rid, prompt, mn)
    jres, tres = jeng.run(), teng.run()
    assert sorted(tres) == sorted(jres)
    for rid, _, mn in trace:
        np.testing.assert_array_equal(tres[rid], np.asarray(jres[rid]), err_msg=rid)
        assert len(tres[rid]) == mn
    if not teng.paged:
        rid, prompt, _ = trace[0]
        eng = BatchedEngine(tcfg, tparams, device="cpu", **kw)
        eng.submit("s", prompt, 5, stop=int(tres[rid][1]))
        assert eng.run()["s"].tolist() == tres[rid][:2].tolist()
        with pytest.raises(RuntimeError, match="dense fallback"):
            eng.step()


def test_recurrent_archs_refuse_paged_serving():
    for arch in ("rwkv6-7b", "zamba2-1.2b"):
        _, tcfg, _, tparams = _model(arch)
        assert not paged_supported(tcfg)
        with pytest.raises(ValueError, match="paged serving requires"):
            BatchedEngine(tcfg, tparams, paged=True, device="cpu")
    _, tcfg, _, tparams = _model("qwen2-7b")
    assert paged_supported(tcfg) and not BatchedEngine(tcfg, tparams, paged=False, device="cpu").paged


def _planes(arch):
    """Two planes of one layout in both packages: the reference's weights and
    a perturbed copy."""
    jcfg, tcfg, jparams, tparams = _model(arch)
    jparams2 = jax.tree.map(lambda t: t * 1.25 + 0.01, jparams)
    jplanes = [jpacking.pack(jparams), jpacking.pack(jparams2)]
    layout = packing.layout_of(tparams)
    tplanes = [interop.packed_from_numpy(_np(p), layout) for p in jplanes]
    return jcfg, tcfg, jplanes, tplanes


def test_swap_plane_applies_at_the_step_boundary_as_jax():
    """The reference's swap test on both engines at once: after 4 steps on
    plane 1 the swap is queued (the served plane is unchanged until the next
    step), and the run ends on plane 2 with the same tokens as the
    reference's engine doing the same swap at the same step."""
    jcfg, tcfg, jplanes, tplanes = _planes("qwen2-7b")
    trace = _trace(np.random.default_rng(5), 3, jcfg.vocab_size, lp=(4, 12), mn=(6, 9))
    kw = dict(slots=2, max_len=32, page_size=8, chunk=8)
    jeng, teng = JaxEngine(jcfg, jplanes[0], **kw), BatchedEngine(tcfg, tplanes[0], device="cpu", **kw)
    base = BatchedEngine(tcfg, tplanes[0], device="cpu", **kw)
    for eng in (jeng, teng, base):
        for rid, prompt, mn in trace:
            eng.submit(rid, prompt, mn)
    base.run()
    for _ in range(4):
        jeng.step(), teng.step()
    jeng.swap_plane(jplanes[1])
    teng.swap_plane(tplanes[1])
    assert teng.plane is tplanes[0]  # pending: never applied mid-step
    for a in teng.sched.active:
        if a is not None:  # what was decoded before the boundary is the no-swap run's
            assert base.results[a.req.rid][: len(a.generated)].tolist() == list(a.generated)
    jres, tres = jeng.run(), teng.run()
    assert teng.plane is tplanes[1]
    assert {k: v.tolist() for k, v in tres.items()} == {k: np.asarray(v).tolist() for k, v in jres.items()}
    assert any(tres[r].tolist() != base.results[r].tolist() for r in tres)  # the swap took effect
    with pytest.raises(ValueError, match="layout"):
        teng.swap_plane(packing.pack({"w": torch.zeros(3)}))
    with pytest.raises(ValueError, match="lead axis"):
        teng.swap_plane(packing.Packed(tuple(b[None] for b in tplanes[1].buffers), tplanes[1].layout))


@pytest.mark.parametrize("arch", ["rwkv6-7b", "zamba2-1.2b"])
def test_dense_engine_serves_a_plane_in_place(arch):
    """The dense fallback on a plane reads the plane's views and gives the
    tokens of the reference's engine on the same plane."""
    jcfg, tcfg, jplanes, tplanes = _planes(arch)
    trace = _trace(np.random.default_rng(8), 2, jcfg.vocab_size, lp=(3, 8), mn=(3, 5))
    jeng, teng = JaxEngine(jcfg, jplanes[1], max_len=16), BatchedEngine(tcfg, tplanes[1], max_len=16, device="cpu")
    _assert_views_of(teng.params, tplanes[1])
    for eng in (jeng, teng):
        for rid, prompt, mn in trace:
            eng.submit(rid, prompt, mn)
    jres, tres = jeng.run(), teng.run()
    assert {k: v.tolist() for k, v in tres.items()} == {k: np.asarray(v).tolist() for k, v in jres.items()}


def _assert_views_of(tree, plane):
    bufs = [(b.untyped_storage().data_ptr(), b.untyped_storage().nbytes()) for b in plane.buffers]
    leaves, _ = packing.tree_flatten(tree)
    for t in leaves:
        p = t.untyped_storage().data_ptr()
        assert any(p == b for b, _ in bufs), "a served leaf does not lie in the plane's storage"
        start = t.data_ptr()
        assert any(b <= start and start + t.numel() * t.element_size() <= b + n for b, n in bufs)


def test_swap_params_restores_a_checkpoint_at_the_boundary(tmp_path):
    """swap_params on a plane engine restores a params checkpoint onto the
    served layout (a per-leaf file packs into the plane) and serves it from
    the next step: the tokens of a fresh engine on the new weights."""
    jcfg, tcfg, jplanes, tplanes = _planes("qwen2-7b")
    path = str(tmp_path / "params.npz")
    checkpoint.save(path, packing.unpack(tplanes[1]))
    prompt = np.arange(3, 10, dtype=np.int32)
    fresh = BatchedEngine(tcfg, tplanes[1], max_len=24, page_size=8, device="cpu")
    fresh.submit("x", prompt, 5)
    want = fresh.run()["x"]
    eng = BatchedEngine(tcfg, tplanes[0], max_len=24, page_size=8, device="cpu")
    eng.swap_params(path)
    assert eng.plane is tplanes[0]
    eng.submit("x", prompt, 5)
    assert eng.run()["x"].tolist() == want.tolist()
    for a, b in zip(eng.plane.buffers, tplanes[1].buffers):
        assert torch.equal(a, b)
    tree_eng = BatchedEngine(tcfg, packing.unpack(tplanes[0]), max_len=24, page_size=8, device="cpu")
    tree_eng.swap_params(path)
    tree_eng.submit("x", prompt, 5)
    assert tree_eng.run()["x"].tolist() == want.tolist()
    with pytest.raises(ValueError, match="per-leaf"):
        tree_eng.swap_plane(tplanes[1])


def test_hot_swap_retries_transient_reads(monkeypatch):
    """The reference's hot_swap test: transient read failures are retried
    with exponential backoff, the last one raised after the budget, and
    structural mismatches (KeyError) never retried."""
    import repro_torch.checkpoint as ckpt

    template = {"w": torch.ones(2, 2)}
    good = {"w": torch.full((2, 2), 3.0)}
    calls = {"n": 0}

    def flaky(path, tmpl):
        calls["n"] += 1
        if calls["n"] < 3:
            raise OSError("file mid-write")
        return good

    sleeps = []
    monkeypatch.setattr(ckpt, "restore", flaky)
    out = hot_swap("x.npz", template, retries=3, backoff=0.01, _sleep=sleeps.append)
    assert bool((out["w"] == 3.0).all())
    assert calls["n"] == 3 and sleeps == [0.01, 0.02]
    calls["n"] = -10  # always failing
    with pytest.raises(OSError):
        hot_swap("x.npz", template, retries=2, backoff=0.0, _sleep=lambda s: None)

    def structural(path, tmpl):
        calls["n"] += 1
        raise KeyError("checkpoint missing 'w'")

    monkeypatch.setattr(ckpt, "restore", structural)
    calls["n"] = 0
    with pytest.raises(KeyError):
        hot_swap("x.npz", template, retries=5, backoff=0.0, _sleep=lambda s: None)
    assert calls["n"] == 1


def test_hot_swap_reads_a_truncated_file_as_transient(tmp_path):
    path = tmp_path / "half.npz"
    checkpoint.save(str(path), {"w": torch.ones(64, 64)})
    path.write_bytes(path.read_bytes()[:100])  # a trainer mid-save
    sleeps = []
    with pytest.raises(Exception) as err:
        hot_swap(str(path), {"w": torch.zeros(64, 64)}, retries=2, backoff=0.5, _sleep=sleeps.append)
    assert not isinstance(err.value, KeyError) and sleeps == [0.5, 1.0]


def test_experiment_serve_serves_the_consensus_plane_in_place(rng):
    """``Experiment.serve`` after a fit: a plane-resident engine whose served
    leaves are views of the consensus plane (no unpack), and which, left
    alone, gives the tokens of an engine on an unpacked copy; then
    ``swap_plane(exp.anchor_plane())`` between two steps of another, every
    request still getting exactly max_new tokens."""
    from repro_torch.api import Experiment

    exp = Experiment(arch="qwen2-7b", workers=2, rounds=1, device="cpu")
    exp.fit()
    eng = exp.serve(slots=2, max_len=32, page_size=8)
    still = exp.serve(slots=2, max_len=32, page_size=8)  # the same consensus plane, never swapped
    for e in (eng, still):
        assert e.plane is not None and e.plane.lead_shape == ()
        _assert_views_of(e.params, e.plane)
    copy = BatchedEngine(exp.model_cfg, packing.unpack(packing.Packed(
        tuple(b.clone() for b in eng.plane.buffers), eng.plane.layout)), slots=2, max_len=32, page_size=8,
        device="cpu")
    trace = _trace(rng, 3, exp.model_cfg.vocab_size, lp=(4, 10), mn=(5, 8))
    for e in (eng, still, copy):
        for rid, prompt, mn in trace:
            e.submit(rid, prompt, mn)
    for _ in range(3):
        eng.step()
    anchor = exp.anchor_plane()
    eng.swap_plane(anchor)
    assert eng.plane is not anchor
    res = eng.run()
    assert eng.plane is anchor
    _assert_views_of(eng.params, anchor)
    want, got = copy.run(), still.run()
    assert {r: t.tolist() for r, t in got.items()} == {r: t.tolist() for r, t in want.items()}
    for rid, _, mn in trace:
        assert len(res[rid]) == mn
    assert sorted(want) == sorted(res)
    with pytest.raises(ValueError, match="LM experiment"):
        from repro_torch.api import ClassificationSpec

        Experiment(task=ClassificationSpec(n=200, holdout=50), device="cpu").serve()


def test_serve_launcher_serves_recurrent_archs_densely(capsys):
    from repro_torch.launch import serve

    for arch in ("rwkv6-7b", "zamba2-1.2b"):
        serve.main(["--arch", arch, "--device", "cpu", "--requests", "2", "--max-new", "3"])
        out = capsys.readouterr().out
        assert "engine: dense fallback" in out and "served 2 requests / 6 tokens" in out


def test_dense_path_imports_no_jax():
    code = textwrap.dedent(
        f"""
        import sys
        sys.path.insert(0, {str(SRC)!r})
        sys.modules["jax"] = None  # any import of jax fails
        import numpy as np, torch
        from repro_torch import checkpoint
        from repro_torch.api import Experiment
        from repro_torch.config import get_arch
        from repro_torch.models import transformer as T
        from repro_torch.serving import BatchedEngine, generate
        for arch in ("rwkv6-7b", "zamba2-1.2b", "qwen2-7b"):
            cfg = get_arch(arch).model.reduced()
            params = T.init_model(cfg, torch.Generator().manual_seed(0))
            out = generate(cfg, params, np.ones((1, 4), np.int32), 3)
            assert out.shape == (1, 3), out.shape
        checkpoint.save("{{}}/p.npz".format(sys.argv[1]), params)
        assert not [m for m in sys.modules if m == "repro" or m.startswith("repro.")]
        print("ok")
        """
    )
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        out = subprocess.run([sys.executable, "-c", code, d], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
