"""Within-worker sharding on gloo CPU ranks (ROADMAP item 10c, first part):
``Experiment.fit`` on a (worker, fsdp) mesh of W = 2 workers × F = 2
fsdp ranks, ZeRO-3 on the packed plane (each rank holds its worker's row
cut to one column slice, gathers the row for the local step and
reduce-scatters the gradient back) and the anchor stored once over every
axis (each rank holds 1/(W·F) of z and v, and Overlap-Local-SGD's
in-flight collective is a reduce-scatter over the worker group).

One spawn of four ranks (``tests/torch_dist_ranks.py``, no JAX in the
ranks) runs every case; the one-process port runs here on the same
weights (the port's own classifier draw), batches, plan and controller.
The small classification task (2,000 samples, 500 held out), m 2, τ 2
(delayed averaging: delay 1, consumed mid-round), 3 rounds; the plan
``crash:1@1-2`` (seed 7), the controller τ 1 in [1, 4], band [0.05, 0.5].
Every strategy of the port that runs on columns: Overlap-Local-SGD (β 0.7
and 0), Local SGD, sync-SGD, EASGD, CoCoD-SGD, delayed averaging and the
gossip family (gossip_full, gossip_ring, gossip_exp, sgp); f32 plain,
faulted, adaptive and both, bf16 plain and both. Stated bounds and why:

* the local step's gradient is the mean of the two fsdp ranks' means over
  their half batches, summed in f32 and divided by 2, where one process
  takes the mean over the whole batch: the same value up to the rounding of
  the sums, so each step moves x by a gradient a few ulps off, and the
  boundaries' worker sums are of two terms either way. Every plane (x, the
  momentum, z, v, the in-flight value, the readers' planes) stays within
  ``ULPS[dtype]`` ulps of its bucket's largest magnitude (v and the
  avg-rebase average: also z's): 16 f32 ulps, 8 bf16 ulps. Observed,
  printed by the test: at most 8 f32 ulps (CoCoD and the sparse gossip
  topologies under faults and adaptive τ together: a re-sync copies an
  anchor that is itself a few ulps apart) and 3.5 bf16 ulps over the 3
  rounds; the bound is twice that;
* losses within rtol 1e-5 (f32: means of the same terms in another order)
  and 4e-3 (bf16: a bf16 plane one ulp apart moves the loss by up to half a
  percent of its scale);
* the fault log and the τ schedule's rounds, τs, decisions and faults
  exactly; the probe's drift and scale within rtol 1e-4 (bf16: 1e-3; the
  ranks add their float64 drift parts over the worker group, then the
  column slices' parts over the fsdp group, from planes a few ulps apart);
  ``evaluate()``'s accuracy within 1 test sample of 500 (bf16: 4; an argmax
  at a near tie flips between planes a few ulps apart; observed: f32 equal,
  bf16 at most 2 apart);
* every reader (``consensus()``, ``consensus_plane()``, ``anchor_plane()``,
  ``evaluate()``) equal on all four ranks, byte for byte;
* what each rank holds: x and the momentum its worker's row cut to c_b =
  ⌈n/2⌉ rounded up to 128 columns (``flat_param``), z, v and the in-flight
  anchor a_b = ⌈c_b/2⌉ rounded up to 128 elements (``anchor_flat``) —
  1/(W·F) of the bucket plus that stated padding;
* the refusals of what still raises with fsdp > 1 (ROADMAP item 10c's
  second part): NotImplementedError naming it; a worker batch that fsdp
  does not divide: ValueError.
"""

import numpy as np
import pytest
import torch

import torch_dist_ranks as ranks

W, F, M, ROUNDS = 2, 2, 2, 3
STRATS = {"overlap": {}, "overlap_beta0": {"anchor_beta": 0.0}, "local_sgd": {"name": "local_sgd"},
          "sync_sgd": {"name": "sync_sgd"}, "easgd": {"name": "easgd"}, "cocod": {"name": "cocod"},
          "delayed_avg": {"name": "delayed_avg", "delay_steps": 1}, "gossip_full": {"name": "gossip_full"},
          "gossip_ring": {"name": "gossip_ring"}, "gossip_exp": {"name": "gossip_exp"}, "sgp": {"name": "sgp"}}
MODES = {"plain": (False, False), "faults": (True, False), "adaptive": (False, True), "both": (True, True)}
CTRL = dict(tau=1, tau_min=1, tau_max=4, lo=0.05, hi=0.5)
PLAN = ("crash:1@1-2", 7)
ULPS = {"float32": 16, "bfloat16": 8}
LOSS_RTOL = {"float32": 1e-5, "bfloat16": 4e-3}
PROBE_RTOL = {"float32": 1e-4, "bfloat16": 1e-3}
ACC_SAMPLES = {"float32": 1, "bfloat16": 4}  # of the 500 held out
SCHEDULE_KEYS = ("round", "tau", "decision", "next_tau", "fault")
FITS = ([(s, "float32", mode) for s in STRATS for mode in MODES]
        + [(s, "bfloat16", mode) for s in STRATS for mode in ("plain", "both")])
ROW_KEYS = ("x", "momentum", "inflight_x0", "inflight_mix")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def classifier_params() -> dict:
    """The small task's classifier as the port draws it (seed 0), numpy f32."""
    from repro_torch.api import ClassificationSpec, Experiment
    from repro_torch.parallel.packing import tree_flatten, tree_unflatten

    exp = Experiment(task=ClassificationSpec(n=2000, holdout=500), device="cpu").build()
    leaves, paths = tree_flatten(exp.params)
    return tree_unflatten(paths, [t.numpy().copy() for t in leaves])


def fit_case(strat, dtype, mode, params, m=M):
    faults, adaptive = MODES[mode]
    return dict(fit=True, strategy=dict(STRATS[strat], tau=2), dtype=dtype, m=m, rounds=ROUNDS, params=params,
                plan=PLAN if faults else None, ctrl=CTRL if adaptive else None)


@pytest.fixture(scope="module")
def mesh22(tmp_path_factory):
    params = classifier_params()
    cases = [fit_case(s, d, mode, params) for s, d, mode in FITS] + [dict(refusal=True)]
    return cases, ranks.spawn(tmp_path_factory.mktemp("fsdp22"), cases, W * F, fsdp=F)


def ulps(a, dtype, n) -> float:
    """n ulps of ``dtype`` at ``a``'s largest magnitude."""
    bits = 24 if dtype == "float32" else 8
    return float(n * np.ldexp(np.float32(1), np.frexp(np.float32(a))[1] - bits))


def worker_rows(per_rank, key, fsdp=F):
    """A row-stacked plane's buckets: each worker's rows (rank w·F, checked
    equal on its F ranks) stacked in worker order."""
    out = []
    for b in range(len(per_rank[0][key])):
        for w in range(len(per_rank) // fsdp):
            assert all(ranks.same_bytes(per_rank[w * fsdp + f][key][b], per_rank[w * fsdp][key][b])
                       for f in range(fsdp)), key
        out.append(np.concatenate([per_rank[w * fsdp][key][b] for w in range(len(per_rank) // fsdp)]))
    return out


def check_fit_within_bounds(per_rank, one, dtype, fsdp=F) -> float:
    """The ranks' fit against the one-process fit within the module's bounds;
    returns the largest error in ulps of its bucket's magnitude."""
    np.testing.assert_allclose(per_rank[0]["loss"], one["loss"], rtol=LOSS_RTOL[dtype])
    assert per_rank[0]["fault_log"] == one["fault_log"]
    if one["tau_schedule"] is not None:
        for got, want in zip(per_rank[0]["tau_schedule"], one["tau_schedule"]):
            assert {k: got.get(k) for k in SCHEDULE_KEYS} == {k: want.get(k) for k in SCHEDULE_KEYS}
            np.testing.assert_allclose([got["drift"], got["scale"]], [want["drift"], want["scale"]],
                                       rtol=PROBE_RTOL[dtype])
    assert per_rank[0]["steps"] == one["steps"]
    for res in per_rank[1:]:  # the readers and everything replicated: alike on every rank
        for key in ("loss", "tau_schedule", "fault_log", "evaluate"):
            assert res[key] == per_rank[0][key], key
        for key in ("consensus", "consensus_plane", "anchor_plane", "vars", "inflight", "inflight_w"):
            if key in one:
                assert all(ranks.same_bytes(a, b) for a, b in zip(res[key], per_rank[0][key])), key
    acc = abs(per_rank[0]["evaluate"]["test_acc"] - one["evaluate"]["test_acc"])
    assert acc <= ACC_SAMPLES[dtype] / 500 + 1e-12, acc
    print(f"accuracy apart by {round(acc * 500)} of 500")
    worst = 0.0
    z_mag = float(np.abs(one["vars"][0]).max()) if one["vars"] else 0.0
    for key in ("x", "momentum", "vars", "inflight", "inflight_x0", "inflight_mix", "inflight_w", "consensus_plane",
                "anchor_plane", "consensus"):
        if key not in one:
            continue
        got = worker_rows(per_rank, key, fsdp) if key in ROW_KEYS else per_rank[0][key]
        assert len(got) == len(one[key]), key
        for g, w in zip(got, one[key]):
            assert g.shape == w.shape, key
            if not w.size:
                continue
            mag = float(np.abs(w).max())
            if key in ("vars", "inflight") and w.ndim == 1 and w.size > 4:  # v and the average: z's scale too
                mag = max(mag, z_mag)
            err = float(np.abs(g.astype(np.float64) - w).max())
            lim = ulps(mag, dtype, ULPS[dtype]) if mag else 0.0
            assert err <= lim, (key, err, lim)
            if mag:
                worst = max(worst, err / ulps(mag, dtype, 1))
    return worst


@pytest.mark.parametrize("idx", range(len(FITS)), ids=["-".join(c) for c in FITS])
def test_fits_on_two_workers_by_two_fsdp_ranks_within_bounds(mesh22, idx):
    cases, per_rank_all = mesh22
    per_rank = [res[idx] for res in per_rank_all]
    one = ranks.run_fit_case(cases[idx])
    worst = check_fit_within_bounds(per_rank, one, FITS[idx][1])
    print(f"{FITS[idx]}: observed {worst:.2f} ulps")


def test_each_rank_holds_its_share(mesh22):
    """x and the momentum: the worker's row cut to c_b columns; z, v and the
    in-flight anchor: a_b elements, 1/(W·F) of the bucket plus the stated
    padding (the classifier's one f32 bucket)."""
    from repro_torch.parallel.packing import layout_of

    cases, per_rank_all = mesh22
    idx = FITS.index(("overlap", "float32", "plain"))
    n = layout_of(cases[idx]["params"]).bucket_sizes[0]
    c = -(-(-(-n // F)) // 128) * 128
    a = -(-(-(-c // W)) // 128) * 128
    assert a * W * F >= n and a * W * F - n < 128 * W * F + 128 * W  # the padding stated in the module docstring
    for res in per_rank_all:
        shares = res[idx]["shares"]
        assert shares["x"] == ("flat_param", [(M // W, c)])
        assert shares["opt::momentum"] == ("flat_param", [(M // W, c)])
        assert shares["vars::z"] == ("anchor_flat", [(a,)]) and shares["vars::v"] == ("anchor_flat", [(a,)])
        assert shares["inflight"] == ("anchor_flat", [(a,)])
    idx = FITS.index(("cocod", "float32", "plain"))
    for res in per_rank_all:
        shares = res[idx]["shares"]
        assert shares["inflight::avg"] == ("anchor_flat", [(a,)])
        assert shares["inflight::x0"] == ("flat_param", [(M // W, c)])


def test_what_raises_with_fsdp_names_10c_second_part(mesh22):
    per_rank_all = mesh22[1]
    for res in per_rank_all:
        got = res[-1]
        for path in ("per_leaf", "legacy", "no_packed_step", "offload", "sparse_anchor", "powersgd", "moe", "tensor",
                     "round_per_leaf"):
            kind, msg = got[path]
            assert kind == "NotImplementedError" and "item 10c, second part" in msg, (path, got[path])
        kind, msg = got["odd_batch"]
        assert kind == "ValueError" and "fsdp" in msg, got["odd_batch"]
