"""Rank program of ``tests/test_torch_dist.py``: W gloo ranks on the CPU,
spawned with ``torch.multiprocessing``, each training its m/W rows of the
cases handed to it. Importing JAX here fails (``sys.modules["jax"] = None``
in every process), so the ranks run the port alone.

    python tests/torch_dist_ranks.py CASES.pkl OUT_DIR WORLD [FSDP]

``CASES.pkl`` holds a list of cases (see :func:`run_case`;
:func:`run_fit_case` for a case with ``fit`` set: ``Experiment.fit`` with
faults and adaptive τ, ``tests/test_torch_dist_fit.py`` and
``tests/test_torch_dist_gossip.py``; :func:`run_ckpt_case` for a case with
``ckpt`` set: the checkpointer on the mesh, ``tests/test_torch_dist_ckpt.py``;
:func:`run_gather_case` for ``gather``: −0.0 through the exact gather;
:func:`run_path_case` for ``path``: a fit of an offloaded or per-leaf
state, its drain and checkpoint, ``tests/test_torch_dist_offload.py`` and
``tests/test_torch_dist_perleaf.py``); each rank writes
``OUT_DIR/rank<r>.pkl``, the results of every case, and the program exits 0
when every rank did. The test process imports this module and calls
:func:`run_case` / :func:`run_fit_case` itself, with no mesh, for the
one-process run of the same cases.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import sys
import time
import traceback

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
if SRC not in sys.path:
    sys.path.insert(0, SRC)

import numpy as np  # noqa: E402
import torch  # noqa: E402

# one case: model ("classifier" or an arch name, reduced), strategy (AlgoConfig
# fields), dtype, m, params (nested dict of float32 numpy arrays), batches
# (one numpy round batch a round: a tuple, or a dict for an LM), lr (None:
# the OptimizerConfig default and its schedule), record (trace the
# collectives and the optimizer steps)


def _planes(p) -> list:
    """A plane's buckets as float32 numpy copies; a rank's share of a plane
    (``Sharded``) gathered whole first (a collective every rank makes)."""
    from repro_torch.parallel import sharding

    return [b.float().numpy().copy() for b in sharding.unshard(p).buffers]


def _params(case):
    from repro_torch import interop

    return interop.params_from_numpy(case["params"], dtype=getattr(torch, case["dtype"]))


def _step_and_state(case, params, rec=None):
    from repro_torch.config import AlgoConfig, OptimizerConfig, get_arch
    from repro_torch.core import make_strategy
    from repro_torch.models import classifier as clf
    from repro_torch.models import transformer as T
    from repro_torch.optim import from_config, schedules
    from repro_torch.training import make_round_step, make_train_state

    lr = case.get("lr")
    ocfg = OptimizerConfig() if lr is None else OptimizerConfig(name="sgd", lr=lr)
    sched = schedules.from_config(ocfg) if lr is None else schedules.constant(lr)
    opt, strat = from_config(ocfg), make_strategy(AlgoConfig(**case["strategy"]))
    if rec is not None:
        opt = rec.wrap(opt)
    if case["model"] == "classifier":
        loss, split = clf.mlp_loss, None
    else:
        cfg = dataclasses.replace(get_arch(case["model"]).model.reduced(), dtype=case["dtype"])
        loss, split = (lambda p, b: T.lm_loss(cfg, p, b)), T.split_layers
    state = make_train_state(params, case["m"], opt, strat)
    return make_round_step(loss, opt, strat, sched, per_worker=split), state


def _batch(nb):
    if isinstance(nb, dict):
        return {k: torch.from_numpy(np.array(v)) for k, v in nb.items()}
    return tuple(torch.from_numpy(np.array(v)) for v in nb)


class _Recorder:
    """Wraps ``sharding.all_reduce_async`` and ``sharding.reduce_scatter_async``
    (until :meth:`close`) and an optimizer's packed step (:meth:`wrap`):
    ``events`` lists ("step",), ("launch", k) and ("wait", k) in order."""

    def __init__(self):
        from repro_torch.parallel import sharding

        self.events, self.sharding = [], sharding
        self.real_reduce, self.real_scatter = sharding.all_reduce_async, sharding.reduce_scatter_async
        rec = self

        class Handle:
            def __init__(self, work, k):
                self.work, self.k = work, k

            def wait(self):
                rec.events.append(("wait", self.k))
                return self.work.wait()

        def reduce(buf, mesh=None):
            k = sum(1 for e in rec.events if e[0] == "launch")
            rec.events.append(("launch", k))
            return Handle(rec.real_reduce(buf, mesh), k)

        def scatter(srcs, outs, mesh=None):
            k = sum(1 for e in rec.events if e[0] == "launch")
            rec.events.append(("launch", k))
            return Handle(rec.real_scatter(srcs, outs, mesh), k)

        sharding.all_reduce_async, sharding.reduce_scatter_async = reduce, scatter

    def wrap(self, opt):
        real = opt.step_packed

        def step(*a, **kw):
            self.events.append(("step",))
            return real(*a, **kw)

        return dataclasses.replace(opt, step_packed=step)

    def close(self):
        self.sharding.all_reduce_async, self.sharding.reduce_scatter_async = self.real_reduce, self.real_scatter


def run_case(case) -> dict:
    """Train ``case`` for its rounds (on the current mesh, if any) and return
    float32 numpy copies of the state: x after the first round and after the
    last, vars.z after each, and after :func:`drain` at the end v, the
    in-flight anchor and the momentum; the losses; with ``record`` the
    trace of collectives and steps."""
    from repro_torch.training import drain

    rec = _Recorder() if case.get("record") else None
    out = {"loss": []}
    try:
        step, state = _step_and_state(case, _params(case), rec)
        for r, nb in enumerate(case["batches"]):
            state, ms = step(state, _batch(nb))
            out["loss"].append(ms["loss"].float().numpy().copy())
            out[f"x{r}"] = _planes(state.x)
            if state.vars.z is not None:
                out[f"z{r}"] = _planes(state.vars.z)
        state = drain(state)
        assert drain(state) is state  # idempotent
    finally:
        if rec is not None:
            rec.close()
    out["x"] = _planes(state.x)
    out["momentum"] = _planes(state.opt.momentum)
    if state.vars.z is not None:
        out["z"], out["v"] = _planes(state.vars.z), _planes(state.vars.v)
    if state.inflight is not None:
        out["inflight"] = _planes(state.inflight)
    if rec is not None:
        out["events"] = rec.events
    return out


def _slot_planes(v) -> list:
    """Every plane of an in-flight value or vars slot, as float32 numpy
    copies: a Packed's buffers, a tensor, a NamedTuple's or tuple's fields
    in order (None skipped)."""
    if v is None:
        return []
    if hasattr(v, "buffers"):
        return _planes(v)
    if isinstance(v, torch.Tensor):
        return [v.float().numpy().copy()]
    return [a for f in v for a in _slot_planes(f)]


def _split_slots(v):
    """(replicated planes, row-stacked planes) of a vars slot: a Packed with
    a worker axis is the rank's rows (PowerSGD's error), the rest is alike
    on every rank."""
    if v is None:
        return [], []
    if hasattr(v, "buffers"):
        return ([], _planes(v)) if len(v.lead_shape) == 1 else (_planes(v), [])
    if isinstance(v, torch.Tensor):
        return [v.float().numpy().copy()], []
    rep, rows = [], []
    for f in v:
        a, b = _split_slots(f)
        rep, rows = rep + a, rows + b
    return rep, rows


def _experiment(case):
    """The small classification task's experiment of ``case`` (on the
    current mesh, if any), its state built from ``case["params"]``: with
    ``case["optimizer"]`` that optimizer's defaults ("sgd" when absent;
    ``case["leafy_opt"]``: the optimizer stripped of its packed step), with
    ``case["legacy"]`` the strategy as the legacy ``Algorithm`` shim."""
    import warnings

    from repro_torch.api import ClassificationSpec, Experiment
    from repro_torch.config import AlgoConfig, OptimizerConfig
    from repro_torch.core.algorithms import make_algorithm
    from repro_torch.optim import from_config, schedules
    from repro_torch.optim.optimizers import Optimizer
    from repro_torch.training import make_train_state

    ocfg = OptimizerConfig(name=case.get("optimizer", "sgd"))
    kw = dict(optimizer=ocfg)
    if case.get("leafy_opt"):
        base = from_config(ocfg)
        kw = dict(optimizer=Optimizer(init=base.init, step=base.step), schedule=schedules.from_config(ocfg))
    strategy = AlgoConfig(**case["strategy"])
    if case.get("legacy"):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            strategy = make_algorithm(strategy)
    exp = Experiment(task=ClassificationSpec(n=2000, holdout=500), strategy=strategy, workers=case["m"],
                     device="cpu", **kw).build()
    exp.state = make_train_state(_params(case), case["m"], exp.opt_obj, exp.strategy_obj)
    if case.get("q") is not None:  # PowerSGD's starting factors, carried across (the reference's draw)
        vars = exp.state.vars
        q = tuple(None if a is None else torch.from_numpy(np.array(a)) for a in case["q"])
        exp.state = exp.state._replace(vars=vars._replace(extra=vars.extra._replace(q=q)))
    return exp


def _fit(exp, case, rounds):
    from repro_torch.control import TauController
    from repro_torch.fault import FaultPlan

    kw = {}
    if case.get("plan"):
        spec, seed = case["plan"]
        kw["faults"] = FaultPlan.parse(spec, m=case["m"], seed=seed)
    if case.get("ctrl"):
        kw["adaptive_tau"] = TauController(**case["ctrl"])
    return exp.fit(rounds=rounds, **kw)


def _state_planes(state) -> dict:
    """x, the momentum, vars (replicated, and the rows of a row-stacked
    slot) and the in-flight value's planes of a drained state."""
    rep, rows = _split_slots(state.vars)
    out = dict(x=_planes(state.x), momentum=_planes(state.opt.momentum), vars=rep)
    if rows:
        out["vars_rows"] = rows
    infl = state.inflight
    if hasattr(infl, "x0"):  # the avg-rebase in-flight: the average (replicated) and x0 (the rows)
        out["inflight"], out["inflight_x0"] = _planes(infl.avg), _planes(infl.x0)
    elif hasattr(infl, "mix"):  # the gossip in-flight: the mix (the rows) and its push weights
        out["inflight_mix"], out["inflight_w"] = _planes(infl.mix), _slot_planes(infl.w)
    elif infl is not None:
        out["inflight"] = _planes(infl)
    return out


def run_fit_case(case) -> dict:
    """``Experiment.fit`` of the small classification task (2,000 samples,
    500 held out) from ``case["params"]`` (cast to ``case["dtype"]``) for
    ``case["rounds"]`` rounds, on the current mesh if any: with
    ``case["plan"]`` (spec, seed) under that fault plan, with
    ``case["ctrl"]`` (TauController fields) under adaptive τ. Returns the
    losses, τ schedule, fault log and steps; after ``drain`` x, the momentum,
    vars and the in-flight value's planes; and the readers: ``consensus()``
    (its leaves), ``consensus_plane()``, ``anchor_plane()`` where there is
    one and ``evaluate()``."""
    from repro_torch.parallel.packing import tree_flatten
    from repro_torch.training import drain

    exp = _experiment(case)
    res = _fit(exp, case, case["rounds"])
    state = exp.state = drain(exp.state)
    out = dict(loss=list(res.losses), tau_schedule=res.tau_schedule, fault_log=res.fault_log, steps=res.steps,
               shares=_shares(state), **_state_planes(state))
    out["consensus"] = [t.numpy().copy() for t in tree_flatten(exp.consensus())[0]]
    out["consensus_plane"] = _planes(exp.consensus_plane())
    if state.vars.z is not None:
        out["anchor_plane"] = _planes(exp.anchor_plane())
    out["evaluate"] = exp.evaluate()
    return out


def _shares(state) -> dict:
    """What the rank holds of each plane of a state, before any gather: per
    checkpoint key, (the rule's axis, or "whole" for a plane the rank keeps
    whole, and each buffer's shape)."""
    from repro_torch.checkpoint import checkpointer as ck
    from repro_torch.parallel import sharding
    from repro_torch.parallel.packing import Packed

    return {key: (node.axis if isinstance(node, sharding.Sharded) else "whole", [tuple(b.shape) for b in node.buffers])
            for key, node in ck._nodes(state) if isinstance(node, Packed)}


def run_refusal_case(case) -> dict:
    """Every path that still raises on the current mesh (fsdp > 1): per
    path, (the exception's type name, its message), or ("ok", "") when it
    ran — the per-leaf path, a legacy Algorithm, an optimizer with no packed
    step, offload, sparse_anchor, PowerSGD, MoE segments (the reduced
    arctic's parameters), tensor > 1 (``logical_mesh``)."""
    import warnings

    from repro_torch.config import AlgoConfig, OptimizerConfig, ParallelPlan, get_arch
    from repro_torch.core import make_strategy
    from repro_torch.core.algorithms import make_algorithm
    from repro_torch.models import classifier as clf
    from repro_torch.models import transformer as T
    from repro_torch.optim import from_config
    from repro_torch.optim.optimizers import Optimizer
    from repro_torch.parallel import sharding
    from repro_torch.training import make_round_step, make_train_state
    from repro_torch.optim import schedules

    params = clf.init_mlp(torch.Generator().manual_seed(0), 8, 3, hidden=(4,))
    opt = from_config(OptimizerConfig())
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        legacy = make_algorithm(AlgoConfig())
    moe = T.init_model(get_arch("arctic-480b").model.reduced(), torch.Generator().manual_seed(0))
    paths = {
        "per_leaf": lambda: make_train_state(params, 2, opt, make_strategy(AlgoConfig(packed=False))),
        "legacy": lambda: make_train_state(params, 2, opt, legacy),
        "no_packed_step": lambda: make_train_state(params, 2, Optimizer(init=opt.init, step=opt.step),
                                                   make_strategy(AlgoConfig())),
        "offload": lambda: make_train_state(params, 2, opt, make_strategy(AlgoConfig(offload=True))),
        "sparse_anchor": lambda: make_train_state(params, 2, opt, make_strategy(AlgoConfig(name="sparse_anchor"))),
        "powersgd": lambda: make_train_state(params, 2, opt, make_strategy(AlgoConfig(name="powersgd"))),
        "moe": lambda: make_train_state(moe, 2, opt, make_strategy(AlgoConfig())),
        "tensor": lambda: sharding.logical_mesh(ParallelPlan(1, 1, 2), device="cpu"),
        # the round engine refuses a per-leaf state it is handed on the mesh too
        "round_per_leaf": lambda: make_round_step(clf.mlp_loss, opt, make_strategy(AlgoConfig(packed=False)),
                                                  schedules.constant(0.1))(
            _no_mesh_state(params, opt), (torch.zeros(2, 2, 2, 8), torch.zeros(2, 2, 2, dtype=torch.int32))),
        # a worker batch that fsdp does not divide
        "odd_batch": lambda: make_round_step(clf.mlp_loss, opt, make_strategy(AlgoConfig()), schedules.constant(0.1))(
            make_train_state(params, 2, opt, make_strategy(AlgoConfig())),
            (torch.zeros(2, 2, 3, 8), torch.zeros(2, 2, 3, dtype=torch.int32))),
    }
    out = {}
    for name, fn in paths.items():
        try:
            fn()
            out[name] = ("ok", "")
        except Exception as e:  # noqa: BLE001 - the type is what is checked
            out[name] = (type(e).__name__, str(e))
    return out


def _no_mesh_state(params, opt):
    """A per-leaf state of 2 workers built off the mesh (the round engine's
    own refusal is then the one that fires)."""
    from repro_torch.config import AlgoConfig
    from repro_torch.core import make_strategy
    from repro_torch.parallel import sharding
    from repro_torch.training import make_train_state

    with sharding.mesh_context(None):
        return make_train_state(params, 2, opt, make_strategy(AlgoConfig(packed=False)))


def run_ckpt_case(case) -> dict:
    """The checkpointer of ``case`` (on the current mesh, if any; every path
    under ``case["dir"]`` with the suffix ``case["tag"]``, "mesh" or "one"):
    ``case["rounds"]`` rounds of ``Experiment.fit`` (0: none), then with
    ``save`` the state saved to ``save-<tag>.npz`` (x's first element of
    the last row set to −0.0 first with ``negzero``), restored into the
    drained state and ``case["more"]`` more rounds; with ``restore`` the
    file ``case["restore"]`` restored into the state (``elastic``) and
    ``case["more"]`` rounds (with ``resave`` the restored state saved to
    ``resave-<name>-<tag>.npz`` first). Returns the losses, the drained
    planes after the save, after the restore and at the end, and what the
    rank holds after the restore (:func:`_shares`)."""
    from repro_torch import checkpoint
    from repro_torch.parallel import sharding
    from repro_torch.training import drain

    tag = "mesh" if sharding.current_mesh() is not None else "one"
    exp = _experiment(case)
    out = {"loss": []}
    if case["rounds"]:
        out["loss"] += list(_fit(exp, case, case["rounds"]).losses)
    if case.get("save"):
        if case.get("negzero"):
            exp.state.x.buffers[0][-1, 0] = -0.0
        path = os.path.join(case["dir"], f"save-{case['name']}-{tag}.npz")
        checkpoint.save(path, exp.state)
        exp.state = drain(exp.state)
        out["saved"] = _state_planes(exp.state)
        exp.state = checkpoint.restore(path, exp.state)
    if case.get("restore"):
        exp.state = checkpoint.restore(case["restore"], exp.state, elastic=case.get("elastic", False))
    out["restored"] = _state_planes(exp.state)
    out["shares"] = _shares(exp.state)
    if case.get("resave"):  # the restored state saved again, before any round
        checkpoint.save(os.path.join(case["dir"], f"resave-{case['name']}-{tag}.npz"), exp.state)
    if case.get("more"):
        out["loss"] += list(_fit(exp, case, case["more"]).losses)
    exp.state = drain(exp.state)
    out["end"] = _state_planes(exp.state)
    return out


def run_gather_case(case) -> dict:
    """:func:`~repro_torch.parallel.sharding.gather_rows_exact` of this
    rank's rows (rank r's rows hold r + 1, rank 1's with −0.0 at every
    other column) in ``case["dtype"]``: the gathered rows as numpy and
    their sign bits."""
    from repro_torch.parallel import sharding

    mesh = sharding.current_mesh()
    rank = 0 if mesh is None else mesh.rank
    t = torch.full((2, 8), float(rank + 1), dtype=getattr(torch, case["dtype"]))
    if rank == 1:
        t[:, ::2] = -0.0
    got = sharding.gather_rows_exact(t, mesh) if mesh is not None else t
    return dict(rows=got.float().numpy(), signbit=torch.signbit(got).numpy())


def _flat_state(state):
    """Every array of a drained state under its checkpoint key, as numpy
    (floats widened to float32; the host planes restored first), and the
    keys of the row-stacked ones (a plane with a worker axis, a per-leaf
    row leaf)."""
    from repro_torch.checkpoint import checkpointer as ck
    from repro_torch.parallel import offload as off
    from repro_torch.parallel import sharding
    from repro_torch.parallel.packing import Packed

    state = state._replace(opt=off.tree_restore(state.opt), vars=off.tree_restore(state.vars),
                           inflight=off.tree_restore(state.inflight))
    row_ids = ck._row_leaves(state)
    arrays, rows = {}, []

    def one(t):
        t = t.detach()
        return (t.float() if t.is_floating_point() else t).numpy().copy()

    for key, node in ck._nodes(state):
        node = sharding.unshard(node)  # a rank's share: the whole plane
        if isinstance(node, Packed):
            for i, b in enumerate(node.buffers):
                arrays[f"{key}::{i}"] = one(b)
                if len(node.lead_shape) == 1:
                    rows.append(f"{key}::{i}")
        else:
            arrays[key] = one(node)
            if id(node) in row_ids:
                rows.append(key)
    return arrays, rows


def run_path_case(case) -> dict:
    """``Experiment.fit`` of an offloaded or per-leaf state (the small
    classification task, :func:`_experiment`) for ``case["rounds"]`` rounds,
    with ``case["plan"]``/``case["ctrl"]`` as :func:`run_fit_case`; the
    drain, twice on the same state and once on its result; the state's
    arrays (:func:`_flat_state`) and the readers (``consensus()``,
    ``evaluate()``, whether ``anchor_plane()`` raises). Then, under
    ``case["dir"]`` with the tag "mesh" or "one": with ``save`` the state
    saved to ``save-<name>-<tag>.npz`` and restored into itself; with
    ``restore`` the file ``case["restore"]`` restored (``elastic``); and
    ``case["more"]`` more rounds."""
    from repro_torch import checkpoint
    from repro_torch.parallel import sharding
    from repro_torch.parallel.packing import tree_flatten
    from repro_torch.training import drain, params_view

    tag = "mesh" if sharding.current_mesh() is not None else "one"
    exp = _experiment(case)
    out = {"loss": []}
    if case["rounds"]:
        res = _fit(exp, case, case["rounds"])
        out.update(loss=list(res.losses), tau_schedule=res.tau_schedule, fault_log=res.fault_log, steps=res.steps)
    pre = exp.state
    state = exp.state = drain(pre)
    again = drain(pre)
    out["drain_idempotent"] = drain(state) is state and _same(_flat_state(again)[0], _flat_state(state)[0])
    out["state"], out["rows"] = _flat_state(state)
    out["x_leaves"] = [t.detach().float().numpy().copy() for t in tree_flatten(params_view(state))[0]]
    out["consensus"] = [t.numpy().copy() for t in tree_flatten(exp.consensus())[0]]
    out["evaluate"] = exp.evaluate()
    try:
        exp.anchor_plane()
        out["anchor_plane"] = "ok"
    except ValueError:
        out["anchor_plane"] = "raises"
    exp.state = drain(exp.state)  # anchor_plane() drained a state already drained: nothing moved
    if case.get("save"):
        path = os.path.join(case["dir"], f"save-{case['name']}-{tag}.npz")
        checkpoint.save(path, exp.state)
        exp.state = checkpoint.restore(path, exp.state)
        out["restored"] = _flat_state(exp.state)[0]
    if case.get("restore"):
        exp.state = checkpoint.restore(case["restore"], exp.state, elastic=case.get("elastic", False))
        out["restored"] = _flat_state(exp.state)[0]
    if case.get("more"):
        out["loss"] += list(_fit(exp, case, case["more"]).losses)
        out["end"] = _flat_state(drain(exp.state))[0]
    return out


def _same(a: dict, b: dict) -> bool:
    """Two dicts of numpy arrays equal key for key, byte for byte."""
    return sorted(a) == sorted(b) and all(same_bytes(a[k], b[k]) for k in a)


def run_any(case) -> dict:
    """The case's runner: refusal, path, fit, ckpt, gather, or a round case."""
    if case.get("refusal"):
        return run_refusal_case(case)
    if case.get("path"):
        return run_path_case(case)
    if case.get("fit"):
        return run_fit_case(case)
    if case.get("ckpt"):
        return run_ckpt_case(case)
    if case.get("gather"):
        return run_gather_case(case)
    return run_case(case)


def _rank(rank: int, world: int, cases_path: str, out_dir: str, fsdp: int = 1) -> None:
    import torch.distributed as dist

    sys.modules["jax"] = None  # the ranks import no JAX
    from repro_torch.core.strategy import RankGossipInflight
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.parallel.sharding import mesh_context

    torch.set_num_threads(1)
    RankGossipInflight.check_phase = True  # the drain holds the host's phase against the device counter
    try:
        with open(cases_path, "rb") as f:
            cases = pickle.load(f)
        dist.init_process_group("gloo", init_method="file://" + os.path.join(out_dir, "rendezvous"),
                                world_size=world, rank=rank, timeout=datetime.timedelta(seconds=_timeout()))
        try:
            with mesh_context(make_smoke_mesh(world // fsdp, fsdp, device="cpu")):
                results = [run_any(c) for c in cases]
        finally:
            dist.destroy_process_group()
        assert not any(k == "jax" or k.startswith(("jax.", "repro.")) for k in sys.modules if sys.modules[k])
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(results, f)
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def spawn(where, cases, world: int, fsdp: int = 1) -> list:
    """Run ``cases`` on ``world`` gloo CPU ranks (a mesh of world/fsdp
    workers × ``fsdp``) in one spawn of this program under the directory
    ``where`` (a ``pathlib.Path``); returns each rank's list of results, in
    global rank order (w·fsdp + f). Raises with the ranks' errors when one
    failed or the spawn outlived its budget."""
    import subprocess

    with open(where / "cases.pkl", "wb") as f:
        pickle.dump(cases, f)
    env = dict(os.environ, PYTHONPATH=SRC, REPRO_SUBPROC_TIMEOUT=str(_timeout()))
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), str(where / "cases.pkl"), str(where), str(world),
                           str(fsdp)], env=env, capture_output=True, text=True, timeout=_timeout())
    if proc.returncode != 0:
        raise RuntimeError(f"{world} ranks failed:\n{proc.stderr[-6000:]}")
    out = []
    for r in range(world):
        with open(where / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


def gathered(per_rank, planes: str = "state") -> dict:
    """The ranks' arrays of ``planes`` (a :func:`run_path_case` result): the
    row-stacked ones concatenated in rank order, the others rank 0's
    (checked byte for byte equal on every rank)."""
    rows = set(per_rank[0]["rows"])
    got = {}
    for key, a in per_rank[0][planes].items():
        if key in rows:
            got[key] = np.concatenate([res[planes][key] for res in per_rank])
        else:
            if not all(same_bytes(res[planes][key], a) for res in per_rank[1:]):
                raise AssertionError(f"{planes} {key}: the ranks' replicated copies differ")
            got[key] = a
    return got


def magnitude(planes: dict, key: str) -> float:
    """The largest magnitude an array's rounding error scales with: its own,
    and for the anchor momentum v and sparse_anchor's error feedback e
    (differences of anchors: a reordered worker sum's rounding is on the
    mean) also the anchor z's."""
    mag = float(np.abs(planes[key]).max())
    for slot in ("vars::v::", "vars::extra::"):
        z = planes.get(key.replace(slot, "vars::z::")) if key.startswith(slot) else None
        if z is not None:
            mag = max(mag, float(np.abs(z).max()))
    return mag


def same_bytes(a, b) -> bool:
    """Two arrays of one dtype and shape with the same bytes."""
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def _timeout() -> int:
    """The spawn's wall-clock budget (REPRO_SUBPROC_TIMEOUT, the test's own)."""
    return int(os.environ.get("REPRO_SUBPROC_TIMEOUT", "300"))


def main(argv) -> int:
    import torch.multiprocessing as mp

    sys.modules["jax"] = None
    cases_path, out_dir, world = argv[0], argv[1], int(argv[2])
    fsdp = int(argv[3]) if len(argv) > 3 else 1
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank, args=(r, world, cases_path, out_dir, fsdp)) for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + _timeout() - 10
    # a rank that fails leaves the others waiting in a collective: stop them all
    while any(p.is_alive() for p in procs):
        if time.monotonic() > deadline or any(p.exitcode not in (None, 0) for p in procs):
            for p in procs:
                p.terminate()
        time.sleep(0.05)
    for p in procs:
        p.join(10)
    errors = [open(os.path.join(out_dir, f)).read() for f in sorted(os.listdir(out_dir)) if f.endswith(".err")]
    if errors or any(p.exitcode != 0 for p in procs):
        print("\n".join(errors) or f"exit codes {[p.exitcode for p in procs]}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
