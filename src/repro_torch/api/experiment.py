"""The ``Experiment`` facade for training (counterpart of
``repro.api.experiment``):

    from repro_torch.api import ClassificationSpec, Experiment

    exp = Experiment(arch="qwen2-7b", strategy="overlap_local_sgd", workers=4, rounds=20)
    exp.fit()
    print(exp.evaluate())          # {'eval_loss': ...} of the consensus model

    exp = Experiment(task=ClassificationSpec(), strategy="overlap_local_sgd", workers=16)
    exp.fit(steps=600)
    print(exp.evaluate())          # {'test_acc': ...}

Two task families, as in the reference: **LM** (``arch`` names a
registered architecture, reduced unless ``full=True``, or is a
``ModelConfig``; data is the synthetic token stream of ``data=``) and
**classification** (``task=ClassificationSpec(...)``, the paper's CIFAR-10
stand-in). The LM loss is taken worker by worker (the round engine's
``per_worker`` mode), each stacked layer its own gradient window.

The experiment runs on the GPU (``device="cuda"``, the default) and raises
where there is none, unless the caller passes ``device="cpu"``; on the CPU
every kernel wrapper takes its plain PyTorch version.

The state is plane-resident: ``state.x`` is the worker-stacked packed
parameter plane. The initial weights come from a seeded ``torch.Generator``
on the CPU (so the CPU and GPU runs of one seed start equal); they differ
from the reference's ``jax.random`` draws, so parity tests carry the
reference's initial state over with :mod:`repro_torch.interop`.

``fit(adaptive_tau=TauController(...))`` hands τ to the controller between
rounds, fed by the consensus probe of each boundary; ``fit(faults=FaultPlan(...))``
runs each round under the plan's membership (rejoining workers re-synced
from the anchor first); the two compose, fault rounds becoming
``fault_hold`` decisions. Every fit reads the device once a round: the
losses (with the probe's two scalars when there is a controller) in one
copy.

Not here yet (each raises): ``serve()`` (item 7) and the archs
``_check_supported`` rejects (item 8); the strategies (every name and alias
of the reference) raise for ``AlgoConfig.packed=False`` (item 4b) and
``AlgoConfig.offload`` (item 9).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.config.base import AlgoConfig, ModelConfig, OptimizerConfig
from repro_torch.config.registry import get_arch
from repro_torch.control import RoundProgramCache, TauController
from repro_torch.core.strategy import CommStrategy, resolve_strategy
from repro_torch.data.loaders import (
    ClassificationSplits,
    classification_batch_fn,
    lm_batch_fn,
    make_classification_splits,
    round_batch,
)
from repro_torch.models import transformer as T
from repro_torch.models.classifier import accuracy, init_mlp, mlp_loss
from repro_torch.optim import from_config as opt_from_config
from repro_torch.optim import schedules
from repro_torch.optim.optimizers import Optimizer
from repro_torch.parallel.packing import Packed, tree_flatten, tree_unflatten
from repro_torch.serving.engine import resolve_device
from repro_torch.training import consensus_params, make_round_step, make_train_state
from repro_torch.training.train_loop import batch_map


@dataclass
class ClassificationSpec:
    """The synthetic classification task (paper §4's CIFAR-10 stand-in)."""

    n: int = 30000
    dim: int = 64
    num_classes: int = 10
    noise: float = 3.0
    holdout: int = 4000
    noniid: bool = False
    skew: float = 0.64
    batch_per_worker: int = 32
    hidden: Tuple[int, ...] = (128, 64)
    seed: int = 0
    splits: Optional[ClassificationSplits] = None  # pre-built; overrides the fields above


@dataclass
class TokenStream:
    """Synthetic LM token-stream spec (bigram-structured, per-worker seeds)."""

    batch_per_worker: int = 2
    seq_len: int = 64
    seed: int = 0


@dataclass
class FitResult:
    losses: List[float]  # per-round mean loss
    state: Any  # final TrainState
    rounds: int
    steps: int  # local steps taken (rounds × τ, or the τ schedule's sum)
    wall_s: float
    tau_schedule: Optional[List[dict]] = None  # the controller's records (adaptive τ)
    fault_log: Optional[List[dict]] = None  # the harness's records of degraded rounds

    @property
    def final_loss(self) -> float:
        return self.losses[-1] if self.losses else float("nan")


@dataclass
class Experiment:
    """Declarative training experiment. See module docstring."""

    arch: Union[str, ModelConfig, None] = None
    task: Optional[ClassificationSpec] = None
    strategy: Union[str, AlgoConfig, CommStrategy] = "overlap_local_sgd"
    optimizer: Union[str, OptimizerConfig, Optimizer] = field(default_factory=OptimizerConfig)
    data: Optional[TokenStream] = None
    workers: int = 4
    rounds: int = 20
    schedule: Optional[Callable] = None  # lr schedule; default derives from the optimizer config
    grad_clip: float = 0.0
    microbatch: Optional[int] = None
    full: bool = False  # the full (not reduced) registered model config
    seed: int = 0
    device: Union[str, torch.device] = "cuda"

    def __post_init__(self):
        if self.arch is None and self.task is None:
            self.task = ClassificationSpec()
        if self.arch is not None and self.task is not None:
            raise ValueError("specify either arch= (LM) or task= (classification), not both")
        self._built = False
        self.state = None

    # -- construction -------------------------------------------------------

    def _resolve_optimizer(self) -> Tuple[Optimizer, Callable]:
        o = self.optimizer
        if isinstance(o, str):
            o = OptimizerConfig(name=o)
        if isinstance(o, OptimizerConfig):
            return opt_from_config(o), self.schedule or schedules.from_config(o)
        if self.schedule is None:
            raise ValueError("a raw Optimizer carries no learning rate; pass schedule= or use an OptimizerConfig")
        return o, self.schedule

    def build(self) -> "Experiment":
        """Resolve configs into data, parameters, state and round step (idempotent)."""
        if self._built:
            return self
        self.dev = resolve_device(self.device)
        self.strategy_obj = resolve_strategy(self.strategy)
        self.opt_obj, self.schedule_fn = self._resolve_optimizer()
        gen = torch.Generator().manual_seed(self.seed)
        if self.task is not None:
            spec = self.task
            self.splits = spec.splits or make_classification_splits(
                self.workers, n=spec.n, dim=spec.dim, num_classes=spec.num_classes, noise=spec.noise,
                holdout=spec.holdout, noniid=spec.noniid, skew=spec.skew, seed=spec.seed,
            )
            if self.splits.num_workers != self.workers:
                raise ValueError(f"task splits have {self.splits.num_workers} partitions but workers={self.workers}")
            self.model_cfg = None
            params = init_mlp(gen, spec.dim, spec.num_classes, hidden=spec.hidden)
            self.loss_fn, self._per_worker = mlp_loss, None
            self.next_batch = classification_batch_fn(self.splits, spec.batch_per_worker, seed=spec.seed)
        else:
            if isinstance(self.arch, ModelConfig):
                cfg = self.arch
            else:
                model = get_arch(self.arch).model
                cfg = model if self.full else model.reduced()
            self.model_cfg = cfg
            stream = self.data or TokenStream()
            params = T.init_model(cfg, gen)
            self.loss_fn, self._per_worker = (lambda p, b: T.lm_loss(cfg, p, b)), T.split_layers
            self.next_batch = lm_batch_fn(cfg, self.workers, stream.batch_per_worker, stream.seq_len, seed=stream.seed)
        leaves, paths = tree_flatten(params)
        self.params = tree_unflatten(paths, [t.to(self.dev) for t in leaves])
        del params, leaves
        self.state = make_train_state(self.params, self.workers, self.opt_obj, self.strategy_obj)
        self.step_fn = make_round_step(self.loss_fn, self.opt_obj, self.strategy_obj, self.schedule_fn,
                                       grad_clip=self.grad_clip, microbatch=self.microbatch,
                                       per_worker=self._per_worker)
        self._built = True
        return self

    def to_device(self, batch):
        """A tuple or dict of host numpy arrays → tensors on the experiment's
        device (pinned and copied without blocking the host on a GPU)."""

        def move(a):
            t = torch.from_numpy(np.array(a, order="C"))
            if self.dev.type == "cuda":
                t = t.pin_memory().to(self.dev, non_blocking=True)
            return t

        return batch_map(move, batch)

    # -- introspection ------------------------------------------------------

    @property
    def tau(self) -> int:
        self.build()
        return self.strategy_obj.tau

    @property
    def num_params(self) -> int:
        self.build()
        return sum(t.numel() for t in tree_flatten(self.params)[0])

    # -- training -----------------------------------------------------------

    def fit(self, rounds: Optional[int] = None, steps: Optional[int] = None,
            log: Optional[Callable[[int, float], None]] = None, adaptive_tau: Optional[TauController] = None,
            faults=None) -> FitResult:
        """Run the round loop; ``steps`` (local steps) is an alternative to
        ``rounds`` (rounds = steps // τ). ``log(round, mean_loss)`` is called
        each round. Fitting continues from the current state. The round's
        losses stay on the device until its end: one host read a round.

        ``adaptive_tau`` (a :class:`~repro_torch.control.TauController`) picks
        each round's τ; the boundary's consensus probe feeds it, and the
        result's ``tau_schedule`` holds its records (``steps`` then counts the
        local steps taken). ``faults`` (a :class:`~repro_torch.fault.FaultPlan`)
        runs every round under the plan's membership and fills ``fault_log``;
        with both, fault rounds are ``fault_hold`` decisions."""
        self.build()
        if faults is not None:
            return self._fit_faulted(faults, rounds or self.rounds, log, ctrl=adaptive_tau)
        if adaptive_tau is not None:
            return self._fit_adaptive(adaptive_tau, rounds or self.rounds, log)
        tau = self.strategy_obj.tau
        if rounds is None:
            rounds = (steps // tau) if steps is not None else self.rounds
        return self._round_loop(rounds, log)

    def _ensure_tau_programs(self) -> None:
        """``self.tau_programs``: the probed round step per τ, counted."""
        if not hasattr(self, "tau_programs"):
            probed = make_round_step(self.loss_fn, self.opt_obj, self.strategy_obj, self.schedule_fn,
                                     grad_clip=self.grad_clip, microbatch=self.microbatch,
                                     per_worker=self._per_worker, probe=True)
            self.tau_programs = RoundProgramCache(lambda tau: probed)

    def _fit_adaptive(self, ctrl: TauController, rounds: int, log) -> FitResult:
        """Each round at the controller's τ, the probed round step feeding it."""
        self._ensure_tau_programs()
        return self._round_loop(rounds, log, ctrl=ctrl)

    def _fit_faulted(self, plan, rounds: int, log, ctrl: Optional[TauController] = None) -> FitResult:
        """Each round under the fault harness: re-sync the rejoining workers,
        install the membership, run the (masked) round; with ``ctrl``, fault
        rounds are fed to it as ``fault_hold``. Leaves the state fully live."""
        from repro_torch.fault import FaultHarness, FaultPlan

        if not isinstance(plan, FaultPlan):
            raise TypeError(f"faults= expects a repro_torch.fault.FaultPlan, got {type(plan).__name__}")
        if plan.m != self.workers:
            raise ValueError(f"fault plan is over m={plan.m} workers, experiment has workers={self.workers}")
        if ctrl is not None:
            self._ensure_tau_programs()
        harness = FaultHarness(plan)
        res = self._round_loop(rounds, log, ctrl=ctrl, harness=harness)
        # a later fit() without faults= runs the unmasked boundary
        self.state = res.state = self.state._replace(membership=None)
        res.fault_log = list(harness.records)
        return res

    def _round_loop(self, rounds: int, log, ctrl: Optional[TauController] = None, harness=None) -> FitResult:
        losses: List[float] = []
        first = len(ctrl.history) if ctrl is not None else 0
        total_steps = 0
        t0 = time.time()
        state = self.state
        for r in range(rounds):
            if harness is not None:
                state = harness.before_round(state, r)
            if ctrl is None:
                tau, step = self.strategy_obj.tau, self.step_fn
            else:
                tau = ctrl.tau
                step = self.tau_programs.program_for(tau)
            state, ms = step(state, self.to_device(round_batch(self.next_batch, tau)))
            loss = ms["loss"]
            if ctrl is None:
                losses.append(float(loss.cpu().numpy().mean()))
            else:
                # one copy: the round's losses and the probe's two scalars
                probe = torch.stack([ms["consensus_drift"], ms["consensus_scale"]])
                vals = torch.cat([loss.reshape(-1).float(), probe]).cpu().numpy()
                losses.append(float(vals[:-2].reshape(tuple(loss.shape)).mean()))
                ctrl.update(float(vals[-2]), float(vals[-1]),
                            fault=harness.fault_reason(r) if harness is not None else None)
            total_steps += tau
            if log is not None:
                log(r, losses[-1])
        self.state = state
        return FitResult(losses=losses, state=state, rounds=rounds, steps=total_steps, wall_s=time.time() - t0,
                         tau_schedule=list(ctrl.history[first:]) if ctrl is not None else None)

    # -- evaluation ---------------------------------------------------------

    def consensus(self) -> dict:
        """The float32 consensus (worker-averaged) model."""
        self.build()
        return consensus_params(self.state)

    def consensus_plane(self) -> Packed:
        """The consensus model as a packed plane (no lead dim): the f32 worker
        mean of each bucket, cast back to the bucket dtype."""
        self.build()
        x = self.state.x
        return Packed(tuple(torch.mean(b.float(), dim=0).to(b.dtype) for b in x.buffers), x.layout)

    def anchor_plane(self) -> Packed:
        """The anchor plane z consumed at the last boundary (anchor-momentum
        strategies), by reference."""
        self.build()
        z = self.state.vars.z if self.state.vars is not None else None
        if not isinstance(z, Packed):
            raise ValueError("anchor_plane() requires a packed anchor strategy (state.vars.z is the plane)")
        return z

    def evaluate(self, eval_batches: int = 8) -> dict:
        """Evaluate the consensus model: classification → held-out accuracy;
        LM → mean loss on ``eval_batches`` fresh token batches (the stream
        seeded ``seed + 7919``, the consensus cast to the param dtype)."""
        self.build()
        if self.task is not None:
            x, y = self.to_device((self.splits.test.x, self.splits.test.y))
            return {"test_acc": float(accuracy(self.consensus(), x, y))}
        cfg = self.model_cfg
        leaves, paths = tree_flatten(self.consensus())
        p = tree_unflatten(paths, [t.to(cfg.param_dtype) for t in leaves])
        if not hasattr(self, "_eval_stream"):
            stream = self.data or TokenStream()
            self._eval_stream = lm_batch_fn(cfg, 1, stream.batch_per_worker, stream.seq_len, seed=stream.seed + 7919)
        losses = []
        with torch.no_grad():
            for _ in range(eval_batches):
                batch = self.to_device({k: v[0] for k, v in self._eval_stream().items()})  # drop the worker axis
                losses.append(float(self.loss_fn(p, batch)[0]))
        return {"eval_loss": float(np.mean(losses))}
