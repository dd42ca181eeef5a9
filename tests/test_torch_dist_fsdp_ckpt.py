"""Within-worker sharding on gloo CPU ranks (ROADMAP item 10c, first
part): one worker over two fsdp ranks (W 1 × F 2), the checkpointer across
(W, F) meshes, and a frontend LM's loss on column slices.

Three spawns (``tests/torch_dist_ranks.py``, no JAX in the ranks): (2, 2),
then (2, 1) (it restores the (2, 2) file), and (1, 2); the one-process port
runs the same cases here, on the port's own classifier draw (the small task,
2,000 samples, 500 held out, τ 2). Stated bounds and why:

* (1, 2) fits of every strategy that runs on columns (Overlap-Local-SGD β
  0.7 and 0, Local SGD, sync-SGD, EASGD, CoCoD-SGD, delayed averaging and
  the gossip family), f32 plain and under faults and adaptive τ together,
  bf16 plain: the bounds of ``tests/test_torch_dist_fsdp.py`` (the same
  fsdp gradient, the mean of two half batches' means);
* the reduced qwen2-vl-7b (M-RoPE, 16 image embeddings through the
  projector; the loss over the text positions), m 2 on (1, 2), 2 rounds of
  Overlap-Local-SGD at lr 1e-2, f32: the reference's ``lm_loss`` passes no
  loss mask (its vision loss is the plain mean over the text logits, as the
  port's), so each fsdp rank's loss is the mean over its half of the
  batch and the worker's loss the mean of the two: losses within rtol 1e-5;
  x, z, v and the in-flight anchor within 4 f32 ulps of each bucket's
  largest magnitude (observed at most 1); the momentum, the sum of 4 steps'
  gradients, each a sum over the batch's 64 token positions taken as two
  half sums, within 32 (observed 12.25: an LM gradient's entries cancel
  far below the bucket's largest one, so their rounding is large against
  it);
* a checkpoint holds values, so every comparison of restored state is bit
  for bit: the (2, 2) ranks' file, restored in one process (the (1, 1) of
  the mesh) and on (2, 1), gives the planes the ranks saved; a one-process
  file (the same bytes a (2, 1) mesh writes, ``tests/test_torch_dist_ckpt.py``)
  restored on (2, 2) and saved again gives the same bytes, and so does the
  (2, 2) file restored on (2, 1) and saved again; the one-process file at m
  2 restored on (2, 2) at m 4 with ``elastic=True`` equals the one-process
  elastic restore; one round after the restore within the fit bounds of the
  one-process round (the fsdp gradient) on (2, 2), bit for bit on (2, 1);
* on (2, 1) each rank holds its worker's whole rows and 1/W of z and v
  (a_b = ⌈n/2⌉ rounded up to 128); on (1, 2) its rows' column slice and
  1/F of z and v.
"""
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_dist_ranks as ranks
from test_torch_dist_fsdp import STRATS, check_fit_within_bounds, classifier_params, fit_case, ulps

FITS12 = ([(s, "float32", mode) for s in STRATS for mode in ("plain", "both")]
          + [(s, "bfloat16", "plain") for s in ("overlap", "cocod", "gossip_ring")])
VL = "qwen2-vl-7b"
LR = 1e-2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    """The shared directory and params, and the one-process file: 2 rounds
    of Overlap-Local-SGD (β 0.7) at m 2, saved."""
    where = tmp_path_factory.mktemp("fsdp_ckpt")
    params = classifier_params()
    one = ranks.run_ckpt_case(ckpt_case("base", where, params, rounds=2, save=True, more=0))
    return where, params, one


def ckpt_case(name, where, params, m=2, **kw):
    return dict(dict(ckpt=True, name=name, strategy=dict(anchor_beta=0.7, tau=2), dtype="float32", m=m,
                     params=params, dir=str(where), rounds=0, more=1), **kw)


def _dir(where, name):
    (Path(where) / name).mkdir()
    return Path(where) / name


def _file(where, name, tag):
    return str(Path(where) / f"{name}-{tag}.npz")


def _vl_case():
    import dataclasses

    from repro_torch.config import get_arch
    from repro_torch.data import loaders
    from repro_torch.models import transformer as T
    from repro_torch.parallel.packing import tree_flatten, tree_unflatten

    cfg = dataclasses.replace(get_arch(VL).model.reduced(), dtype="float32")
    params = T.init_model(cfg, torch.Generator().manual_seed(0))
    leaves, paths = tree_flatten(params)
    nb = loaders.lm_batch_fn(cfg, 2, 2, 32, seed=3)
    return dict(model=VL, strategy=dict(tau=2), dtype="float32", m=2, lr=LR,
                params=tree_unflatten(paths, [t.float().numpy().copy() for t in leaves]),
                batches=[loaders.round_batch(nb, 2) for _ in range(2)])


@pytest.fixture(scope="module")
def mesh22(work):
    where, params, _ = work
    base = _file(where, "save-base", "one")
    cases = [ckpt_case("a", where, params, rounds=2, save=True),
             ckpt_case("r", where, params, restore=base, resave=True),
             ckpt_case("e", where, params, m=4, restore=base, elastic=True)]
    return cases, ranks.spawn(_dir(where, "m22"), cases, 4, fsdp=2)


@pytest.fixture(scope="module")
def mesh21(work, mesh22):
    where, params, _ = work
    cases = [ckpt_case("b", where, params, restore=_file(where, "save-a", "mesh"), resave=True)]
    return cases, ranks.spawn(_dir(where, "m21"), cases, 2, fsdp=1)


@pytest.fixture(scope="module")
def mesh12(work):
    where, params, _ = work
    cases = [fit_case(s, d, mode, params) for s, d, mode in FITS12] + [_vl_case()]
    return cases, ranks.spawn(_dir(where, "m12"), cases, 2, fsdp=2)


def _equal(a: dict, b: dict, keys=None):
    for key in keys or a:
        if isinstance(a[key], list):
            assert len(a[key]) == len(b[key]) and all(ranks.same_bytes(x, y) for x, y in zip(a[key], b[key])), key


def _gathered_rows(per_rank, planes, fsdp):
    """A ckpt result's drained planes with the row-stacked ones (x, the
    momentum) stacked over the workers (rank w·F)."""
    out = dict(per_rank[0][planes])
    for key in ("x", "momentum"):
        out[key] = [np.concatenate([res[planes][key][b] for res in per_rank[::fsdp]])
                    for b in range(len(out[key]))]
    return out


@pytest.mark.parametrize("idx", range(len(FITS12)), ids=["-".join(c) for c in FITS12])
def test_fits_on_one_worker_by_two_fsdp_ranks_within_bounds(mesh12, idx):
    cases, per_rank_all = mesh12
    per_rank = [res[idx] for res in per_rank_all]
    one = ranks.run_fit_case(cases[idx])
    worst = check_fit_within_bounds(per_rank, one, FITS12[idx][1], fsdp=2)
    print(f"{FITS12[idx]}: observed {worst:.2f} ulps")
    n = per_rank[0]["shares"]["x"][1][0][1]
    assert per_rank[0]["shares"]["x"][0] == "flat_param" and n * 2 >= one["x"][0].shape[1]
    if "vars::z" in per_rank[0]["shares"]:
        assert per_rank[0]["shares"]["vars::z"] == ("anchor_flat", [(n,)])  # W 1: the piece is the slice


def test_qwen2_vl_loss_on_column_slices_within_bounds(mesh12):
    cases, per_rank_all = mesh12
    per_rank = [res[-1] for res in per_rank_all]
    one = ranks.run_case(cases[-1])
    for res in per_rank:
        np.testing.assert_allclose(np.stack(res["loss"]), np.stack(one["loss"]), rtol=1e-5)
    worst = 0.0
    for key in ("x0", "x", "z0", "z", "v", "inflight", "momentum"):
        for res in per_rank:  # W 1: both ranks hold (and gather) the worker's whole state
            for g, w in zip(res[key], one[key]):
                mag = max(float(np.abs(w).max()), float(np.abs(one["z"][0]).max()) if key == "v" else 0.0)
                err = float(np.abs(g - w).max())
                assert err <= ulps(mag, "float32", 32 if key == "momentum" else 4), (key, err)
                worst = max(worst, err / ulps(mag, "float32", 1))
    print(f"qwen2-vl: observed {worst:.2f} ulps")


def test_a_file_saved_on_2x2_restores_in_one_process_bit_for_bit(work, mesh22):
    where, params, _ = work
    cases, per_rank_all = mesh22
    saved = _gathered_rows([res[0] for res in per_rank_all], "saved", 2)
    one = ranks.run_ckpt_case(ckpt_case("a1", where, params, restore=_file(where, "save-a", "mesh"), more=0))
    _equal(one["restored"], saved)
    for res in per_rank_all[1:]:  # the ranks' anchor readers alike
        _equal(res[0]["saved"], per_rank_all[0][0]["saved"], ("vars", "inflight"))


def test_a_file_saved_on_2x2_restores_on_2x1_bit_for_bit(work, mesh22, mesh21):
    where, params, _ = work
    saved = _gathered_rows([res[0] for res in mesh22[1]], "saved", 2)
    per_rank = [res[0] for res in mesh21[1]]
    _equal(_gathered_rows(per_rank, "restored", 1), saved)
    with open(_file(where, "resave-b", "mesh"), "rb") as f, open(_file(where, "save-a", "mesh"), "rb") as g:
        assert f.read() == g.read()
    # one round after: bit for bit the one-process round from the same file (W 2 × F 1 is the stacked run)
    one = ranks.run_ckpt_case(ckpt_case("b1", where, params, restore=_file(where, "save-a", "mesh")))
    assert per_rank[0]["loss"] == one["loss"]
    _equal(_gathered_rows(per_rank, "end", 1), one["end"])
    n = one["end"]["x"][0].shape[1]
    a = -(-(-(-n // 2)) // 128) * 128
    for res in per_rank:  # F 1: the worker's whole rows, 1/W of the anchor
        assert res["shares"]["x"] == ("whole", [(1, n)])
        assert res["shares"]["vars::z"] == ("anchor_flat", [(a,)]) == res["shares"]["vars::v"]


def test_a_one_process_file_on_2x2_saves_the_same_bytes_and_trains_within_bounds(work, mesh22):
    where, params, base = work
    cases, per_rank_all = mesh22
    with open(_file(where, "resave-r", "mesh"), "rb") as f, open(_file(where, "save-base", "one"), "rb") as g:
        assert f.read() == g.read()
    per_rank = [res[1] for res in per_rank_all]
    one = ranks.run_ckpt_case(cases[1])
    _equal(_gathered_rows(per_rank, "restored", 2), one["restored"])
    np.testing.assert_allclose(per_rank[0]["loss"], one["loss"], rtol=1e-5)
    got = _gathered_rows(per_rank, "end", 2)
    for key in ("x", "momentum", "vars", "inflight"):
        for g, w in zip(got[key], one["end"][key]):
            assert float(np.abs(g - w).max()) <= ulps(float(np.abs(w).max()), "float32", 16), key


def test_elastic_restore_onto_m4_on_2x2(work, mesh22):
    where, params, _ = work
    cases, per_rank_all = mesh22
    per_rank = [res[2] for res in per_rank_all]
    one = ranks.run_ckpt_case(cases[2])
    _equal(_gathered_rows(per_rank, "restored", 2), one["restored"])
    np.testing.assert_allclose(per_rank[0]["loss"], one["loss"], rtol=1e-5)
