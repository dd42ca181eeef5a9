"""The port's serving slice (repro_torch) against the JAX reference, on the CPU.

The JAX package builds the weights (``T.init_model``); they cross to the port
through ``repro_torch.interop.params_from_numpy``, and both packages run the
same seeded numpy token traces. Stated tolerance for logits in f32:
rtol 1e-5, atol 1e-5 — the two packages' matmuls sum in other orders.
Greedy tokens and scheduler events must be identical.
"""
import dataclasses
import functools
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
from repro.serving import BatchedEngine as JaxEngine
from repro.serving import Request as JaxRequest
from repro.serving import Scheduler as JaxScheduler
from repro.serving import paged_step as jax_paged_step
from repro.serving.paged_cache import init_paged_pools as jax_pools
from repro.serving.paged_cache import pool_bytes as jax_pool_bytes
from repro_torch import interop
from repro_torch.config import get_arch
from repro_torch.models import transformer as T
from repro_torch.serving import BatchedEngine, Request, Scheduler, init_paged_pools, paged_step, pool_bytes

SRC = Path(__file__).resolve().parents[1] / "src"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small CPU ops: torch's thread pool only contends with XLA's here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(num_kv_heads=None):
    jcfg = jax_get_arch("qwen2-7b").model.reduced()
    tcfg = get_arch("qwen2-7b").model.reduced()
    if num_kv_heads is not None:
        jcfg = dataclasses.replace(jcfg, attention=dataclasses.replace(jcfg.attention, num_kv_heads=num_kv_heads))
        tcfg = dataclasses.replace(tcfg, attention=dataclasses.replace(tcfg.attention, num_kv_heads=num_kv_heads))
    return jcfg, tcfg


def _jax_params(jcfg, seed=0):
    params, _ = JT.init_model(jcfg, jax.random.PRNGKey(seed))
    # random QKV biases (their init is zeros) so the bias path is exercised
    k = jax.random.PRNGKey(seed + 100)
    attn = dict(params["seg0"]["attn"])
    for i, name in enumerate(("bq", "bk", "bv")):
        attn[name] = 0.1 * jax.random.normal(jax.random.fold_in(k, i), attn[name].shape, attn[name].dtype)
    params["seg0"] = dict(params["seg0"], attn=attn)
    return params


def _to_numpy(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def qwen():
    jcfg, tcfg = _cfgs()
    jparams = _jax_params(jcfg)
    return jcfg, tcfg, jparams, interop.params_from_numpy(_to_numpy(jparams))


# -- config and parameters -------------------------------------------------------


@pytest.mark.parametrize("reduced", [False, True])
def test_config_copy_matches_reference(reduced):
    j = jax_get_arch("qwen2-7b")
    t = get_arch("qwen2-7b")
    jm, tm = (j.model.reduced(), t.model.reduced()) if reduced else (j.model, t.model)
    assert dataclasses.asdict(jm) == dataclasses.asdict(tm)
    assert tm.param_dtype == (torch.float32 if reduced else torch.bfloat16)
    assert dataclasses.asdict(j.plans["default"]) == dataclasses.asdict(t.plans["default"])


def test_init_model_tree_matches_reference_shapes():
    jcfg, tcfg = _cfgs()
    jparams, _ = JT.init_model(jcfg, jax.random.PRNGKey(0))
    tparams = T.init_model(tcfg, torch.Generator().manual_seed(0))
    jflat = {jax.tree_util.keystr(p): tuple(v.shape) for p, v in jax.tree_util.tree_flatten_with_path(jparams)[0]}

    def walk(tree, prefix=""):
        for k, v in tree.items():
            key = f"{prefix}['{k}']"
            if isinstance(v, dict):
                yield from walk(v, key)
            else:
                yield key, tuple(v.shape)

    assert dict(walk(tparams)) == jflat
    # init rules: fan_in N(0, 1/d_in), embedding N(0, 0.02²), zero biases, unit norms
    w = tparams["seg0"]["ffn"]["wi_gate"]
    assert abs(float(w.std()) - tcfg.d_model ** -0.5) < 0.05 * tcfg.d_model ** -0.5
    assert abs(float(tparams["tok_emb"].std()) - 0.02) < 0.002
    assert float(tparams["seg0"]["attn"]["bq"].abs().sum()) == 0.0
    assert bool((tparams["seg0"]["ln1"]["scale"] == 1).all())


def test_params_from_numpy_bf16_bits():
    a = jnp.asarray(np.linspace(-3, 3, 11), jnp.bfloat16)
    t = interop.params_from_numpy({"w": np.asarray(a)})["w"]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(), np.asarray(a.astype(jnp.float32)))


def test_pool_bytes_and_pool_layout_match_reference():
    jcfg, tcfg = _cfgs(num_kv_heads=2)
    assert pool_bytes(tcfg, 9, 4) == jax_pool_bytes(jcfg, 9, 4)
    jp = jax_pools(jcfg, 9, 4)
    tp = init_paged_pools(tcfg, 9, 4)
    assert {k: {n: tuple(v.shape) for n, v in d.items()} for k, d in tp.items()} == {
        k: {n: tuple(v.shape) for n, v in d.items()} for k, d in jp.items()
    }


# -- the forward: paged_step logits ---------------------------------------------------


@pytest.mark.parametrize("num_kv_heads", [None, 2])
def test_paged_step_logits_match_jax(num_kv_heads):
    """A prefill chunk into two slots, then 9 joint decode steps (one slot idle
    on the trash page for the first four), teacher-forced through both
    packages' ``paged_step``. ``num_kv_heads=2`` gives G = 2 query heads per KV
    head (the reduced config alone has G = 1)."""
    jcfg, tcfg = _cfgs(num_kv_heads)
    jparams = _jax_params(jcfg, seed=1)
    tparams = interop.params_from_numpy(_to_numpy(jparams))
    rng = np.random.default_rng(3)
    page, maxp, slots, chunk = 4, 8, 3, 6
    pt = np.arange(1, slots * maxp + 1, dtype=np.int32).reshape(slots, maxp)
    jp = jax_pools(jcfg, slots * maxp + 1, page)
    tp = init_paged_pools(tcfg, slots * maxp + 1, page)
    steps = [
        (rng.integers(0, jcfg.vocab_size, (1, chunk)), pt[1:2], np.asarray([0])),
        (rng.integers(0, jcfg.vocab_size, (1, chunk)), pt[2:3], np.asarray([0])),
        (rng.integers(0, jcfg.vocab_size, (1, chunk)), pt[2:3], np.asarray([chunk])),
    ]
    for i in range(9):
        tables = pt.copy()
        lens = np.asarray([i - 4 if i >= 4 else 0, chunk + i, 2 * chunk + i])
        if i < 4:
            tables[0] = 0
        steps.append((rng.integers(0, jcfg.vocab_size, (slots, 1)), tables, lens))
    jstep = jax.jit(functools.partial(jax_paged_step, jcfg))
    for toks, tables, lens in steps:
        toks, tables, lens = toks.astype(np.int32), np.ascontiguousarray(tables, np.int32), lens.astype(np.int32)
        jl, jp = jstep(jparams, jnp.asarray(toks), jp, jnp.asarray(tables), jnp.asarray(lens))
        tl, tp = paged_step(tcfg, tparams, torch.from_numpy(toks), tp, torch.from_numpy(tables), torch.from_numpy(lens))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5, atol=1e-5)
    for key in jp:
        for name in ("pool_k", "pool_v"):
            np.testing.assert_allclose(tp[key][name][:, 1:].numpy(), np.asarray(jp[key][name])[:, 1:], rtol=1e-5, atol=1e-5)


# -- the engine ---------------------------------------------------------------------------


def _trace(rng, n, vmax, lp, mn):
    return [
        (f"r{i}", rng.integers(1, vmax, (int(rng.integers(*lp)),)).astype(np.int32), int(rng.integers(*mn)))
        for i in range(n)
    ]


def _drive(engine, trace, arrive_at=2, first=4):
    for rid, prompt, mn in trace[:first]:
        engine.submit(rid, prompt, mn)
    steps = 0
    while engine.sched.busy:
        engine.step()
        steps += 1
        if steps == arrive_at:  # mid-run arrivals at a fixed step index
            for rid, prompt, mn in trace[first:]:
                engine.submit(rid, prompt, mn)
    return {k: np.asarray(v).tolist() for k, v in engine.results.items()}, list(engine.sched.events)


def test_engine_matches_jax_engine_tokens_and_events(qwen):
    """Seven requests over two slots with a pool too small for both to stay
    resident: mid-run arrivals, evictions and requeues. Same greedy tokens per
    request and the same scheduler event list as the JAX engine."""
    jcfg, tcfg, jparams, tparams = qwen
    trace = _trace(np.random.default_rng(42), 7, jcfg.vocab_size, lp=(3, 14), mn=(2, 7))
    kw = dict(slots=2, max_len=24, page_size=4, num_pages=7, chunk=8)
    jres, jev = _drive(JaxEngine(jcfg, jparams, **kw), trace)
    tres, tev = _drive(BatchedEngine(tcfg, tparams, device="cpu", **kw), trace)
    assert any(e[0] == "evict" for e in jev)
    assert tev == jev
    assert tres == jres


def test_cobatched_equals_solo_within_port(qwen):
    _, tcfg, _, tparams = qwen
    trace = _trace(np.random.default_rng(5), 5, tcfg.vocab_size, lp=(3, 30), mn=(2, 8))
    eng = BatchedEngine(tcfg, tparams, slots=3, max_len=48, page_size=8, chunk=8, device="cpu")
    for rid, prompt, mn in trace:
        eng.submit(rid, prompt, mn)
    res = eng.run()
    for rid, prompt, mn in trace:
        solo = BatchedEngine(tcfg, tparams, slots=1, max_len=48, page_size=8, chunk=8, device="cpu")
        solo.submit(rid, prompt, mn)
        np.testing.assert_array_equal(solo.run()[rid], res[rid], err_msg=rid)
        assert len(res[rid]) == mn
    assert eng.sched.alloc.available == eng.sched.alloc.capacity  # no page leak


def test_replay_is_deterministic_and_stop_tokens_free_early(qwen):
    _, tcfg, _, tparams = qwen
    trace = _trace(np.random.default_rng(9), 5, tcfg.vocab_size, lp=(3, 14), mn=(2, 6))
    runs = [_drive(BatchedEngine(tcfg, tparams, slots=2, max_len=24, page_size=4, num_pages=9, chunk=8,
                                 device="cpu"), trace) for _ in range(2)]
    assert runs[0] == runs[1]
    rid, prompt, _ = trace[0]
    free = runs[0][0][rid]
    eng = BatchedEngine(tcfg, tparams, slots=2, max_len=32, page_size=8, device="cpu")
    eng.submit("s", prompt, 6, stop=free[1])
    assert eng.run()["s"].tolist() == free[:2]


def test_scheduler_copy_emits_reference_events():
    """Pure host code: the same operations give the same events and tables."""
    scheds = [cls(slots=2, num_pages=6, page_size=4, max_pages_per_slot=4) for cls in (JaxScheduler, Scheduler)]
    for s, req in zip(scheds, (JaxRequest, Request)):
        for i, n in enumerate((5, 9, 3)):
            s.submit(req(f"q{i}", np.ones(n, np.int32), 4))
        s.admit()
        s.ensure_pages(0, 4)
        s.ensure_pages(1, 8)
        s.ensure_pages(0, 12)  # exhausts the pool: evicts the younger slot
        s.complete(0)
        s.admit()
    assert scheds[0].events == scheds[1].events
    np.testing.assert_array_equal(scheds[0].table, scheds[1].table)


def test_engine_validations(qwen):
    _, tcfg, _, tparams = qwen
    eng = BatchedEngine(tcfg, tparams, slots=2, max_len=16, page_size=4, device="cpu")
    eng.submit("a", np.ones(4, np.int32), 2)
    with pytest.raises(ValueError, match="duplicate"):
        eng.submit("a", np.ones(4, np.int32), 2)
    with pytest.raises(ValueError, match="non-empty 1-D"):
        eng.submit("b", np.ones((2, 2), np.int32), 2)
    with pytest.raises(ValueError, match="exceeds"):
        eng.submit("d", np.ones(14, np.int32), 8)
    with pytest.raises(ValueError, match="params live on"):
        BatchedEngine(tcfg, dict(tparams, tok_emb=tparams["tok_emb"].to("meta")), device="cpu")
    mla = dataclasses.replace(tcfg, attention=dataclasses.replace(tcfg.attention, kind="mla"))
    with pytest.raises(ValueError, match="GQA"):
        BatchedEngine(mla, tparams, device="cpu")


def test_entry_points_default_to_cuda(qwen):
    """Without a GPU the engine and the launcher raise unless asked for the CPU."""
    _, tcfg, _, tparams = qwen
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the CUDA default does not raise here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BatchedEngine(tcfg, tparams)
    from repro_torch.launch import serve

    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "qwen2-7b", "--requests", "1", "--max-new", "2"])


def test_serve_launcher_on_cpu(capsys):
    from repro_torch.launch import serve

    serve.main(["--arch", "qwen2-7b", "--device", "cpu", "--requests", "3", "--max-new", "3"])
    out = capsys.readouterr().out
    assert "engine: paged" in out and "served 3 requests / 9 tokens" in out


# -- package isolation ------------------------------------------------------------------


def test_port_imports_no_jax_and_nothing_of_repro():
    code = textwrap.dedent(
        f"""
        import importlib, pkgutil, sys
        sys.path.insert(0, {str(SRC)!r})
        sys.modules["jax"] = None  # any import of jax fails
        import repro_torch
        names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
        for n in names:
            importlib.import_module(n)
        bad = sorted(m for m in sys.modules if m == "repro" or m.startswith("repro."))
        assert not bad, bad
        assert "repro_torch.serving.engine" in names and "repro_torch.launch.serve" in names, names
        print(len(names))
        """
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20
