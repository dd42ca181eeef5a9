"""The checkpointer on worker ranks (``repro_torch.checkpoint`` under a
``mesh_context``), on the CPU over gloo.

The ranks run ``tests/torch_dist_ranks.py::run_ckpt_case`` in one spawn of
two ranks for every case (and one spawn of four ranks for the move from W 2
to W 4), importing no JAX; the one-process port runs the same cases here
and the JAX package restores the ranks' files. The small classification
task (2,000 samples, 500 held out), τ 2, 2 rounds before a save, one round
after a restore. A checkpoint holds values, not computations, so every
comparison is bit for bit (the bytes of every array; bf16 is widened to f32
losslessly):

* the file two ranks of one row save (m 2: rank 0 writes after the
  row-stacked planes are gathered) against the one-process ``save`` of the
  same run: the same keys and the same bytes, for Overlap-Local-SGD (z, v,
  the anchor), CoCoD (the average and x₀'s rows), gossip_ring and
  gossip_exp (the mix's rows, w, t), sparse_anchor (z, the error e) and
  PowerSGD (q, the error's rows), f32 and bf16; the state restored on the
  ranks from their own file, and one more round after it, bit for bit the
  one-process run's;
* at m 4 (two rows a rank) the file holds the ranks' drained planes;
* a one-process file restored on the ranks, and a round after it, bit for
  bit the one-process restore and round; a one-process file at m 2 onto
  the ranks at m 4 with ``elastic=True`` equal to the one-process elastic
  restore; the ranks' m 4 file into one process (m 4, and m 2 elastic) and
  onto four ranks (W 2 → W 4 at the same m: each rank's rows, then a round
  within rtol 1e-5 of the one-process round from the same file);
* the ranks' files restore in the JAX package: ``repro.checkpoint.restore``
  into the reference's template, saved again by the reference, gives the
  same bytes;
* −0.0 survives the exact gather (``gather_rows_exact``) and the file.
"""
import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import torch_dist_ranks as ranks
from repro.api import ClassificationSpec as JSpec
from repro.api import Experiment as JExperiment
from repro.checkpoint import restore as jrestore
from repro.checkpoint import save as jsave
from repro.config import AlgoConfig as JAlgo

SRC = Path(__file__).resolve().parents[1] / "src"
HELPER = Path(__file__).with_name("torch_dist_ranks.py")
_TIMEOUT = int(os.environ.get("REPRO_SUBPROC_TIMEOUT", "300"))
SMALL = dict(n=2000, holdout=500)
STRATS = {"overlap": {"anchor_beta": 0.7}, "cocod": {"name": "cocod"}, "gossip_ring": {"name": "gossip_ring"},
          "gossip_exp": {"name": "gossip_exp"}, "sparse_anchor": {"name": "sparse_anchor", "sparse_k": 0.25},
          "powersgd": {"name": "powersgd"}}
SAVE_M2 = [(s, d) for s in STRATS for d in ("float32", "bfloat16")]
SAVE_M4 = ["overlap", "gossip_exp", "powersgd"]
RESTORE = ["overlap", "cocod", "gossip_ring", "sparse_anchor", "powersgd"]
ELASTIC = ["overlap", "gossip_ring"]
JAX_RESTORE = ["overlap", "gossip_ring", "sparse_anchor", "powersgd"]
ROWS = ("x", "momentum", "vars_rows", "inflight_x0", "inflight_mix")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(strat, dtype, m, where, **kw):
    return dict(dict(ckpt=True, strategy=dict(STRATS[strat], tau=2), dtype=dtype, m=m, params=_params(),
                     dir=str(where), rounds=2, more=1), **kw)


_P = {}


def _params():
    if "p" not in _P:
        j = JExperiment(task=JSpec(**SMALL), workers=2).build()
        _P["p"] = jax.tree.map(lambda a: np.asarray(a, np.float32), j.params)
    return _P["p"]


def _spawn(where, cases, world):
    with open(where / "cases.pkl", "wb") as f:
        pickle.dump(cases, f)
    env = dict(os.environ, PYTHONPATH=str(SRC), REPRO_SUBPROC_TIMEOUT=str(_TIMEOUT))
    try:
        proc = subprocess.run([sys.executable, str(HELPER), str(where / "cases.pkl"), str(where), str(world)],
                              env=env, capture_output=True, text=True, timeout=_TIMEOUT)
    except subprocess.TimeoutExpired:
        pytest.fail(f"{world} ranks exceeded {_TIMEOUT}s (REPRO_SUBPROC_TIMEOUT to raise)")
    assert proc.returncode == 0, proc.stderr[-6000:]
    out = []
    for r in range(world):
        with open(where / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """The one-process files the ranks restore, then every case on two gloo
    ranks in one spawn. Returns (named cases, per-rank results by name,
    the directory)."""
    where = tmp_path_factory.mktemp("dist_ckpt")
    cases = {}
    for strat, dtype in SAVE_M2:
        cases[f"save-{strat}-{dtype}-m2"] = _case(strat, dtype, 2, where, save=True)
    for strat in SAVE_M4:
        cases[f"save-{strat}-float32-m4"] = _case(strat, "float32", 4, where, save=True)
    cases["negzero"] = _case("gossip_ring", "float32", 2, where, save=True, negzero=True)
    for strat in RESTORE:  # the one-process file of the m 2 save case, restored into a fresh state
        cases[f"restore-{strat}"] = _case(strat, "float32", 2, where, rounds=0,
                                          restore=str(where / f"save-save-{strat}-float32-m2-one.npz"))
    for strat in ELASTIC:  # the same file onto m 4
        cases[f"elastic-{strat}"] = _case(strat, "float32", 4, where, rounds=0, more=0, elastic=True,
                                          restore=str(where / f"save-save-{strat}-float32-m2-one.npz"))
    cases["gather-float32"] = dict(gather=True, dtype="float32")
    cases["gather-bfloat16"] = dict(gather=True, dtype="bfloat16")
    for name, case in cases.items():
        case["name"] = name
    for strat in RESTORE:  # the files the restore cases read
        ranks.run_ckpt_case(cases[f"save-{strat}-float32-m2"])
    per_rank = _spawn(where, list(cases.values()), 2)
    return cases, {name: [res[i] for res in per_rank] for i, name in enumerate(cases)}, where


def _gather(per_rank, planes, key):
    return [np.concatenate([res[planes][key][b] for res in per_rank]) for b in range(len(per_rank[0][planes][key]))]


def _planes_equal(per_rank, planes, one, name):
    """The ranks' planes of ``planes`` (rows gathered in rank order)
    against a one-process dict of planes, bit for bit."""
    got = per_rank[0][planes]
    assert sorted(got) == sorted(one), name
    for key, want in one.items():
        have = _gather(per_rank, planes, key) if key in ROWS else got[key]
        assert len(have) == len(want) and all(_same_bytes(a, b) for a, b in zip(have, want)), (name, planes, key)
        if key not in ROWS:
            assert all(all(_same_bytes(a, b) for a, b in zip(res[planes][key], want)) for res in per_rank[1:])


def _same_bytes(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


# -- the ranks' file is the one-process file ------------------------------------------------


@pytest.mark.parametrize("strat,dtype", SAVE_M2, ids=["-".join(c) for c in SAVE_M2])
def test_rank_file_is_the_one_process_file_bit_for_bit(spawned, strat, dtype):
    cases, results, where = spawned
    name = f"save-{strat}-{dtype}-m2"
    one = ranks.run_ckpt_case(cases[name])
    got, want = _npz(where / f"save-{name}-mesh.npz"), _npz(where / f"save-{name}-one.npz")
    assert sorted(got) == sorted(want)
    for key in want:
        assert _same_bytes(got[key], want[key]), key
    per_rank = results[name]
    for planes in ("saved", "restored", "end"):
        _planes_equal(per_rank, planes, one[planes], name)
    assert per_rank[0]["loss"] == one["loss"] == per_rank[1]["loss"]


@pytest.mark.parametrize("strat", SAVE_M4)
def test_rank_file_at_two_rows_a_rank_holds_the_ranks_planes(spawned, strat):
    """m 4: the file's arrays are the ranks' drained planes (rows gathered),
    and the ranks' own restore gives them back."""
    cases, results, where = spawned
    name = f"save-{strat}-float32-m4"
    per_rank = results[name]
    stored = _npz(where / f"save-{name}-mesh.npz")
    saved = per_rank[0]["saved"]
    x = _gather(per_rank, "saved", "x")
    assert all(_same_bytes(stored[f"x::{b}"], x[b]) for b in range(len(x)))
    assert all(_same_bytes(stored[f"opt::momentum::{b}"], a) for b, a in enumerate(_gather(per_rank, "saved", "momentum")))
    if "vars_rows" in saved:  # PowerSGD's error rows
        rows = _gather(per_rank, "saved", "vars_rows")
        assert all(_same_bytes(stored[f"vars::extra::err::{b}"], a) for b, a in enumerate(rows))
    if "inflight_mix" in saved:
        mix = _gather(per_rank, "saved", "inflight_mix")
        assert all(_same_bytes(stored[f"inflight::mix::{b}"], a) for b, a in enumerate(mix))
    for key in saved:
        have = _gather(per_rank, "restored", key) if key in ROWS else per_rank[0]["restored"][key]
        want = _gather(per_rank, "saved", key) if key in ROWS else saved[key]
        assert all(_same_bytes(a, b) for a, b in zip(have, want)), key


# -- restores across W and m ----------------------------------------------------------------


@pytest.mark.parametrize("strat", RESTORE)
def test_one_process_file_restores_on_ranks_bit_for_bit(spawned, strat):
    cases, results, _ = spawned
    name = f"restore-{strat}"
    one = ranks.run_ckpt_case(cases[name])
    per_rank = results[name]
    for planes in ("restored", "end"):
        _planes_equal(per_rank, planes, one[planes], name)
    assert per_rank[0]["loss"] == one["loss"]


@pytest.mark.parametrize("strat", ELASTIC)
def test_one_process_file_onto_more_workers_on_ranks(spawned, strat):
    """A one-process m 2 file onto two ranks at m 4 (``elastic=True``: the
    new rows seeded from row 0) equals the one-process elastic restore."""
    cases, results, _ = spawned
    name = f"elastic-{strat}"
    one = ranks.run_ckpt_case(cases[name])
    _planes_equal(results[name], "restored", one["restored"], name)
    x = np.concatenate([res["restored"]["x"][0] for res in results[name]])
    assert x.shape[0] == 4 and np.array_equal(x[2], x[0])


def test_rank_file_restores_into_one_process(spawned):
    """The ranks' m 4 file into one process: at m 4 every plane the ranks
    saved; at m 2 (elastic) their first two rows."""
    from repro_torch import checkpoint

    cases, results, where = spawned
    for strat in SAVE_M4:
        name = f"save-{strat}-float32-m4"
        per_rank = results[name]
        path = where / f"save-{name}-mesh.npz"
        for m in (4, 2):
            exp = ranks._experiment(dict(cases[name], m=m))
            state = checkpoint.restore(str(path), exp.state, elastic=m != 4)
            got = ranks._state_planes(state)
            for key, want in per_rank[0]["saved"].items():
                want = _gather(per_rank, "saved", key) if key in ROWS else want
                if key in ROWS:
                    want = [w[:m] for w in want]
                elif key == "inflight_w" or (strat == "gossip_exp" and key == "vars"):
                    continue  # the (m,) push weights: resized by the elastic restore below
                assert all(_same_bytes(a, b) for a, b in zip(got[key], want)), (name, m, key)
            if strat == "gossip_exp":
                w = _npz(path)["inflight::w"]
                assert np.array_equal(got["inflight_w"][0], w[:m])


def test_two_rank_file_onto_four_ranks(spawned, tmp_path):
    """W 2 → W 4 at the same m (4): each of four ranks keeps its row of the
    two ranks' file, bit for bit; one round after it within rtol 1e-5 of
    the one-process round from the same file (a four-term worker sum over
    four ranks in the transport's order)."""
    cases, results, where = spawned
    moves = {}
    for strat in SAVE_M4:
        path = str(where / f"save-save-{strat}-float32-m4-mesh.npz")
        moves[strat] = dict(_case(strat, "float32", 4, tmp_path, rounds=0, restore=path), name=f"w4-{strat}")
    per_rank = _spawn(tmp_path, list(moves.values()), 4)
    for i, (strat, case) in enumerate(moves.items()):
        got = [res[i] for res in per_rank]
        saved = results[f"save-{strat}-float32-m4"]
        for key in saved[0]["saved"]:
            want = _gather(saved, "saved", key) if key in ROWS else saved[0]["saved"][key]
            have = _gather(got, "restored", key) if key in ROWS else got[0]["restored"][key]
            assert all(_same_bytes(a, b) for a, b in zip(have, want)), (strat, key)
        one = ranks.run_ckpt_case(case)
        np.testing.assert_allclose(got[0]["loss"], one["loss"], rtol=1e-5)


@pytest.mark.parametrize("strat", JAX_RESTORE)
def test_rank_file_restores_in_the_reference(spawned, strat, tmp_path):
    """The JAX package restores the ranks' file into its own template and
    writes it again: the same bytes under every key."""
    cases, _, where = spawned
    path = where / f"save-save-{strat}-float32-m2-mesh.npz"
    j = JExperiment(task=JSpec(**SMALL), strategy=JAlgo(**dict(STRATS[strat], tau=2)), workers=2).build()
    back = jrestore(str(path), j.state)
    jsave(str(tmp_path / "back.npz"), back)
    got, want = _npz(tmp_path / "back.npz"), _npz(path)
    assert sorted(got) == sorted(want)
    for key in want:
        assert _same_bytes(got[key], want[key]), key


# -- −0.0 -----------------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_negative_zero_survives_the_gather(spawned, dtype):
    _, results, _ = spawned
    for res in results[f"gather-{dtype}"]:
        rows = res["rows"]
        assert rows.shape == (4, 8) and np.array_equal(rows[:2], np.ones((2, 8)))
        assert res["signbit"][2:, ::2].all() and not res["signbit"][2:, 1::2].any() and not res["signbit"][:2].any()


def test_negative_zero_survives_the_file(spawned):
    _, results, where = spawned
    x = _npz(where / "save-negzero-mesh.npz")["x::0"]
    assert x[-1, 0] == 0.0 and np.signbit(x[-1, 0])
    assert _same_bytes(x, _gather(results["negzero"], "saved", "x")[0])

