"""The port's checkpointer (repro_torch.checkpoint) against the JAX reference's
(repro.checkpoint), on the CPU.

Both packages write the same .npz format, so a file written by either
restores in the other. States are built by the reference (the MLP
classifier, plane-resident ``TrainState``) and carried to the port bit for
bit with ``repro_torch.interop``. Stated tolerance: bitwise for every
restore (a checkpoint holds values, not computations), f32 and bf16 (bf16 is
widened to f32 on save, losslessly). The one computation here, a training
round after a restore, is compared with the reference's round at
test_torch_training.py's one-round bound (rtol 1e-5, atol 1e-6) and with the
port's own uninterrupted round bitwise.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpointer as jckpt
from repro.checkpoint import restore as jrestore
from repro.checkpoint import save as jsave
from repro.config import AlgoConfig as JAlgo
from repro.config import OptimizerConfig as JOpt
from repro.core import make_strategy as jmake_strategy
from repro.data import loaders as jloaders
from repro.models import classifier as jclf
from repro.optim import from_config as jopt_from_config
from repro.optim import schedules as jsched
from repro.parallel import packing as jpacking
from repro.training import make_round_step as jmake_round_step
from repro.training import make_train_state as jmake_train_state
from repro_torch import checkpoint, interop
from repro_torch.checkpoint import checkpointer as tckpt
from repro_torch.config import AlgoConfig, OptimizerConfig
from repro_torch.core import make_strategy
from repro_torch.models import classifier as clf
from repro_torch.optim import from_config as opt_from_config
from repro_torch.optim import schedules
from repro_torch.parallel import packing
from repro_torch.training import make_round_step

DIM, CLASSES, HIDDEN, BATCH, TAU, LR = 8, 4, (16, 8), 8, 2, 0.05


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _strategy(name):
    return dict(name=name, tau=TAU, alpha=0.6, anchor_beta=0.7)


def _batches(rounds, m, seed=3):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(TAU, m, BATCH, DIM)).astype(np.float32),
             rng.integers(0, CLASSES, size=(TAU, m, BATCH)).astype(np.int32)) for _ in range(rounds)]


class _Ref:
    """A reference plane-resident classifier run: its initial and trained
    states, and the port's template (the initial state carried across)."""

    def __init__(self, strategy="overlap_local_sgd", opt="sgd", dtype="float32", m=4, rounds=2, packed=True):
        jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
        self.jparams, _ = jclf.init_mlp(jax.random.PRNGKey(0), DIM, CLASSES, hidden=HIDDEN, dtype=jd)
        self.algo = _strategy(strategy)
        self.opt = opt
        self.jopt = jopt_from_config(JOpt(name=opt))
        self.jstrat = jmake_strategy(JAlgo(packed=packed, **self.algo))
        self.m = m
        self.jinit = jmake_train_state(self.jparams, m, self.jopt, self.jstrat)
        self.jstep = jax.jit(jmake_round_step(jclf.mlp_loss, self.jopt, self.jstrat, jsched.constant(LR)))
        self.jstate = self.jinit
        for b in _batches(rounds, m):
            self.jstate = self.jstep(self.jstate, b)[0]
        self.tparams = interop.params_from_numpy(_np(self.jparams))
        self.layout = packing.layout_of(self.tparams)

    def port(self, jstate):
        return interop.state_from_numpy(_np(jstate), self.layout)

    def port_step(self):
        return make_round_step(clf.mlp_loss, opt_from_config(OptimizerConfig(name=self.opt)),
                               make_strategy(AlgoConfig(**self.algo)), schedules.constant(LR))


def _pairs(port_tree, ref_tree):
    """(port tensor, reference array) leaf pairs in the reference's flatten order."""
    nodes = tckpt._nodes(port_tree)
    leaves = []
    for _, n in nodes:
        leaves.extend(n.buffers if isinstance(n, packing.Packed) else [n])
    ref = jax.tree.leaves(ref_tree)
    assert len(leaves) == len(ref)
    return list(zip(leaves, ref))


def _assert_bitwise(port_tree, ref_tree):
    for t, j in _pairs(port_tree, ref_tree):
        j = np.asarray(j)
        assert tuple(t.shape) == j.shape
        if t.dtype == torch.bfloat16:
            assert j.dtype.name == "bfloat16"
            np.testing.assert_array_equal(t.float().numpy(), j.astype(np.float32))
        else:
            assert str(t.dtype).split(".")[-1] == j.dtype.name
            np.testing.assert_array_equal(t.numpy(), j)


CASES = [("overlap_local_sgd", "sgd", "float32"), ("overlap_local_sgd", "sgd", "bfloat16"),
         ("overlap_local_sgd", "adamw", "float32"), ("overlap_local_sgd", "adamw", "bfloat16"),
         ("gossip_ring", "sgd", "float32"), ("gossip_ring", "sgd", "bfloat16")]
IDS = [f"{s}-{o}-{d}" for s, o, d in CASES]


@pytest.mark.parametrize("strategy,opt,dtype", CASES, ids=IDS)
def test_reference_checkpoint_restores_in_port_bitwise(tmp_path, strategy, opt, dtype):
    ref = _Ref(strategy, opt, dtype)
    path = str(tmp_path / "ref.npz")
    jsave(path, ref.jstate)
    restored = checkpoint.restore(path, ref.port(ref.jinit))
    assert type(restored) is type(ref.port(ref.jinit))
    _assert_bitwise(restored, ref.jstate)
    assert restored.x.buffers[0].dtype == getattr(torch, dtype)


@pytest.mark.parametrize("strategy,opt,dtype", CASES, ids=IDS)
def test_port_checkpoint_restores_in_reference_bitwise(tmp_path, strategy, opt, dtype):
    """The port trains one more round from the reference's state and saves;
    the reference restores the file into its own template."""
    ref = _Ref(strategy, opt, dtype)
    state, _ = ref.port_step()(ref.port(ref.jstate), tuple(map(torch.from_numpy, _batches(1, ref.m, seed=9)[0])))
    path = str(tmp_path / "port.npz")
    checkpoint.save(path, state)
    back = jrestore(path, ref.jinit)
    _assert_bitwise(state, back)
    # and the two packages write the same keys, shapes and dtypes
    jsave(str(tmp_path / "ref.npz"), back)
    with np.load(path) as a, np.load(str(tmp_path / "ref.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("strategy", ["overlap_local_sgd", "gossip_ring", "delayed_avg", "powersgd", "sparse_anchor"])
def test_port_roundtrip_bitwise_keeps_dtypes(tmp_path, strategy):
    ref = _Ref(strategy, "sgd", "bfloat16" if strategy == "overlap_local_sgd" else "float32")
    state = ref.port(ref.jstate)
    path = str(tmp_path / "rt.npz")
    checkpoint.save(path, state)
    back = checkpoint.restore(path, ref.port(ref.jinit))
    a, b = tckpt._nodes(state), tckpt._nodes(back)
    assert [k for k, _ in a] == [k for k, _ in b]
    for (k, x), (_, y) in zip(a, b):
        xs = x.buffers if isinstance(x, packing.Packed) else (x,)
        ys = y.buffers if isinstance(y, packing.Packed) else (y,)
        for u, v in zip(xs, ys):
            assert u.dtype == v.dtype and u.shape == v.shape and torch.equal(u, v), k


def _tree_dtypes():
    return {"b": torch.zeros(3, dtype=torch.bfloat16), "a": {"w": torch.zeros(2, 5), "v": torch.zeros(130)},
            "c": torch.zeros(4, 4, dtype=torch.bfloat16)}


def test_layout_sidecar_bytes_equal_the_reference():
    tree = _tree_dtypes()
    jtree = {"b": jnp.zeros(3, jnp.bfloat16), "a": {"w": jnp.zeros((2, 5)), "v": jnp.zeros(130)},
             "c": jnp.zeros((4, 4), jnp.bfloat16)}
    want = jckpt._encode_layout(jpacking.layout_of(jtree)).tobytes()
    got = tckpt._encode_layout(packing.layout_of(tree)).tobytes()
    assert got == want
    assert json.loads(got)["bucket_dtypes"] == ["bfloat16", "float32"]


def test_layout_sidecar_of_a_trained_state_equals_the_references(tmp_path):
    ref = _Ref("overlap_local_sgd", "adamw", "bfloat16")
    jsave(str(tmp_path / "j.npz"), ref.jstate)
    checkpoint.save(str(tmp_path / "t.npz"), ref.port(ref.jstate))
    with np.load(str(tmp_path / "j.npz")) as a, np.load(str(tmp_path / "t.npz")) as b:
        sidecars = [k for k in a.files if k.endswith("__layout__")]
        assert sorted(sidecars) == sorted(k for k in b.files if k.endswith("__layout__"))
        assert len(sidecars) == 6  # x, opt.mu, opt.nu (f32 retagged layouts), vars.z, vars.v, inflight
        for k in sidecars:
            assert a[k].tobytes() == b[k].tobytes(), k


@pytest.mark.parametrize("opt", ["sgd", "adamw"])
def test_reference_perleaf_checkpoint_restores_into_port_packed_template(tmp_path, opt):
    """Cross-format: the reference's per-leaf (``packed=False``) checkpoint
    packs into the port's plane-resident template with the template's
    layout; AdamW's per-worker (m,) counts become the scalar count."""
    packed = _Ref("overlap_local_sgd", opt)
    perleaf = _Ref("overlap_local_sgd", opt, packed=False)
    path = str(tmp_path / "perleaf.npz")
    jsave(path, perleaf.jstate)
    restored = checkpoint.restore(path, packed.port(packed.jinit))
    assert isinstance(restored.x, packing.Packed)
    # the reference's own restore of the same file into its packed template
    _assert_bitwise(restored, jrestore(path, packed.jinit))
    if opt == "adamw":
        assert restored.opt.count.shape == ()


def _to_torch(tree):
    """A reference tree with its containers kept (NamedTuples, dicts) and
    every array a tensor: a per-leaf template for the port's restore."""
    if tree is None:
        return None
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_to_torch(v) for v in tree))
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_to_torch(v) for v in tree)
    return interop.params_from_numpy(np.asarray(tree))


@pytest.mark.parametrize("opt", ["sgd", "adamw"])
def test_port_packed_checkpoint_restores_into_perleaf_template(tmp_path, opt):
    """Cross-format the other way: the port's packed checkpoint slices into a
    per-leaf template (the reference's ``packed=False`` state, its arrays as
    tensors) exactly as the reference's restore of the same file; AdamW's
    scalar count becomes the per-worker (m,) counts."""
    packed = _Ref("overlap_local_sgd", opt)
    perleaf = _Ref("overlap_local_sgd", opt, packed=False)
    path = str(tmp_path / "packed.npz")
    state = packed.port(packed.jstate)
    checkpoint.save(path, state)
    got = checkpoint.restore(path, _to_torch(perleaf.jinit))
    _assert_bitwise(got, jrestore(path, perleaf.jinit))
    got_x, _ = packing.tree_flatten(got.x)
    for t, v in zip(got_x, packing.leaf_views(state.x)):  # the plane's values, leaf by leaf
        assert torch.equal(t, v)
    if opt == "adamw":
        assert tuple(got.opt.count.shape) == (packed.m,)


@pytest.mark.parametrize("opt", ["sgd", "adamw"])
def test_elastic_restore_matches_the_reference(tmp_path, opt):
    """A checkpoint of m = 2 workers restores at m = 4, and that one at m = 6
    (grow seeds new rows from row 0) and back at m = 2 (shrink keeps the
    first rows), as the reference's ``restore(..., elastic=True)``."""
    runs = {m: _Ref("overlap_local_sgd", opt, m=m, rounds=1) for m in (2, 4, 6)}
    path = str(tmp_path / "m2.npz")
    jsave(path, runs[2].jstate)
    for m_new in (4, 6):
        got = checkpoint.restore(path, runs[m_new].port(runs[m_new].jinit), elastic=True)
        _assert_bitwise(got, jrestore(path, runs[m_new].jinit, elastic=True))
        assert got.x.buffers[0].shape[0] == m_new
        path = str(tmp_path / f"m{m_new}.npz")
        checkpoint.save(path, got)
    back = checkpoint.restore(path, runs[2].port(runs[2].jinit), elastic=True)
    _assert_bitwise(back, jrestore(path, runs[2].jinit, elastic=True))
    with pytest.raises(ValueError, match="shape"):
        checkpoint.restore(path, runs[2].port(runs[2].jinit))


def test_restore_errors_name_the_missing_key(tmp_path):
    path = str(tmp_path / "t.npz")
    checkpoint.save(path, {"w": torch.ones(2, 2)})
    with pytest.raises(KeyError, match="'v'"):
        checkpoint.restore(path, {"w": torch.zeros(2, 2), "v": torch.zeros(1)})
    out = checkpoint.restore(path, {"w": torch.zeros(2, 2, dtype=torch.bfloat16)})
    assert out["w"].dtype == torch.bfloat16 and bool((out["w"] == 1).all())


@pytest.mark.parametrize("opt,dtype", [("sgd", "float32"), ("adamw", "float32"), ("sgd", "bfloat16")])
def test_crash_recovery_round_after_restore(tmp_path, opt, dtype):
    """Kill and restore: the port checkpoints after round 2, the live state
    is dropped, a fresh template takes the file, and round 3 from it equals
    the port's uninterrupted round 3 bit for bit, and the reference's round
    3 (one-round bound, f32; in bf16 the port's own run only)."""
    ref = _Ref("overlap_local_sgd", opt, dtype, rounds=3)
    step = ref.port_step()
    batches = [tuple(map(torch.from_numpy, b)) for b in _batches(3, ref.m)]
    straight = ref.port(ref.jinit)
    for b in batches:
        straight = step(straight, b)[0]
    interrupted = ref.port(ref.jinit)
    for b in batches[:2]:
        interrupted = step(interrupted, b)[0]
    path = str(tmp_path / "crash.npz")
    checkpoint.save(path, interrupted)
    del interrupted
    resumed = step(checkpoint.restore(path, ref.port(ref.jinit)), batches[2])[0]
    for (k, a), (_, b) in zip(tckpt._nodes(straight), tckpt._nodes(resumed)):
        for u, v in zip(*(n.buffers if isinstance(n, packing.Packed) else (n,) for n in (a, b))):
            assert torch.equal(u, v), k
    if dtype == "float32":
        for t, j in _pairs(resumed, ref.jstate):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5, atol=1e-6)


def test_train_launcher_saves_a_checkpoint_that_restores(tmp_path, capsys):
    from repro_torch.api import Experiment
    from repro_torch.launch import train as train_cli

    path = str(tmp_path / "lm.npz")
    train_cli.main(["--arch", "qwen2-7b", "--rounds", "2", "--device", "cpu", "--seq", "16", "--workers", "2",
                    "--ckpt", path])
    assert f"checkpoint -> {path}" in capsys.readouterr().out
    template = Experiment(arch="qwen2-7b", workers=2, device="cpu").build().state
    state = checkpoint.restore(path, template)
    assert int(state.step) == 4  # 2 rounds of tau 2
    assert not torch.equal(state.x.buffers[0], template.x.buffers[0])


def test_two_bucket_lm_state_roundtrips_between_the_packages(tmp_path):
    """The reduced arctic-480b in bf16 (a bf16 bucket and the MoE router's
    f32 bucket), after one Overlap-Local-SGD round of the reference: the
    reference's file restores in the port bitwise, the port's file (after a
    round of its own) restores in the reference bitwise, and both write the
    same keys, values and layout sidecars."""
    from repro.api import Experiment as JExperiment
    from repro.api import TokenStream as JTokenStream
    from repro.config import get_arch as jget_arch
    from repro_torch.api import Experiment, TokenStream
    from repro_torch.config import get_arch

    def pair():
        jcfg = dataclasses.replace(jget_arch("arctic-480b").model.reduced(), dtype="bfloat16")
        tcfg = dataclasses.replace(get_arch("arctic-480b").model.reduced(), dtype="bfloat16")
        kw = dict(workers=2, rounds=1)
        j = JExperiment(arch=jcfg, optimizer=JOpt(name="sgd", lr=LR), schedule=jsched.constant(LR),
                        data=JTokenStream(2, 16), **kw).build()
        p = Experiment(arch=tcfg, optimizer=OptimizerConfig(name="sgd", lr=LR), schedule=schedules.constant(LR),
                       data=TokenStream(2, 16), device="cpu", **kw).build()
        return j, p, packing.layout_of(p.params)

    j, p, layout = pair()
    jinit = j.state
    assert j.state.x.layout.bucket_dtypes == ("bfloat16", "float32") == layout.bucket_dtypes
    j.fit(rounds=1)
    jpath = str(tmp_path / "ref.npz")
    jsave(jpath, j.state)
    restored = checkpoint.restore(jpath, interop.state_from_numpy(_np(jinit), layout))
    _assert_bitwise(restored, j.state)
    assert [b.dtype for b in restored.x.buffers] == [torch.bfloat16, torch.float32]

    p.state = restored
    p.fit(rounds=1)
    ppath = str(tmp_path / "port.npz")
    checkpoint.save(ppath, p.state)
    back = jrestore(ppath, jinit)
    _assert_bitwise(p.state, back)
    jsave(str(tmp_path / "again.npz"), back)
    with np.load(ppath) as a, np.load(str(tmp_path / "again.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        assert any(k.endswith("::1") for k in a.files)  # the f32 bucket of each plane
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
