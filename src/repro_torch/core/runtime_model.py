"""Wall-clock runtime model for the error–runtime tradeoff (paper Figs. 1/4/5);
the port's copy of ``repro.core.runtime_model`` (pure numpy, value for value).

Simulates per-worker clocks under a straggler model and a communication
model, for every algorithm in the comparison. This is how the paper's
runtime claims are validated quantitatively on CPU-only hardware: the
*convergence* curves come from real training runs; the *time axis* comes
from this model. The default constants are the paper's own measured 2020
setup (ResNet-18/CIFAR-10 on 16 × Titan X over 40 Gbps Ethernet):

    compute ≈ 4.6 s/epoch  (24-25 steps/epoch ⇒ ~0.19 s/step)
    fully-sync all-reduce ≈ 1.5 s/epoch (comm/compute ≈ 34.6% incl. overhead)
    PowerSGD rank-1 compresses 243× but keeps the handshake latency.

They are *defaults, not assumptions*: :func:`calibrated_config` rebuilds a
``RuntimeConfig`` from a production dry-run JSON — worker count from the
parallel plan, per-step compute from the roofline, collective time from the
measured boundary-collective bytes over a given link — and
:meth:`repro_torch.fault.plan.FaultPlan.runtime_config` layers a fault plan's
straggler/jitter distributions on top (replacing the hardcoded straggler
knobs). :func:`simulate` accepts an optional ``fault_plan`` whose per-round
compute factors, crash windows, and network jitter drive the clocks: dead
workers drop out of barriers, rejoining workers resume at the round clock.

Blocking semantics per algorithm:
    sync_sgd   — barrier + blocking all-reduce every step
    powersgd   — barrier + blocking compressed all-reduce every step
    local_sgd  — barrier + blocking all-reduce every τ steps
    easgd      — same barrier structure as local_sgd (z update is synchronous
                 in [19] when run without its (rare) async variant)
    overlap_local_sgd / cocod — NON-blocking: collective launched at a
                 boundary is consumed at the next one; a worker only waits if
                 the collective is still in flight when it arrives there.
    gossip_*   — NON-blocking like overlap, but the barrier is per-worker:
                 worker i waits only on its *in-neighbors* for the round's
                 mixing matrix (:mod:`repro_torch.core.topology`), and the
                 collective payload is priced by the topology degree —
                 t_handshake + (t_comm − t_handshake)·degree/(m−1), so the
                 degenerate fully-connected case prices exactly like the
                 global model. This is what lets the error–runtime figures
                 project to thousands-of-worker fleets, where a global
                 barrier is the wrong cost model (a ring worker at m=4096
                 still waits on 2 neighbors and ships 2 model copies).

Shared semantics across branches:
* a trailing ``steps % tau`` partial segment advances the clocks by its
  compute but runs no boundary (there is no round to average);
* an overlapped run's total includes the *final* boundary's in-flight
  collective — the last averaged model does not exist until it completes;
* an all-dead round (possible once crash windows are authoritative in
  :meth:`FaultPlan.mask_at`) skips its collective entirely: clocks advance
  by the round's compute and the round is counted in
  ``RuntimeResult.skipped_rounds``. This mirrors the live path, where
  :func:`repro_torch.fault.membership.from_mask` refuses to build an all-dead
  boundary host-side — the simulator records the hole instead of raising
  mid-sweep.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass, field, replace
from typing import Dict, Optional

import numpy as np

BLOCKING = {"sync_sgd": 1, "powersgd": 1, "local_sgd": None, "easgd": None}
OVERLAPPED = ("overlap_local_sgd", "cocod")
# overlapped gossip strategies: per-worker neighbor barriers, degree-priced
# collectives; the topology comes from the name (or an explicit override)
GOSSIP = ("gossip_pushsum", "gossip_full", "gossip_ring", "gossip_exp")
_GOSSIP_TOPOLOGY = {
    "gossip_pushsum": "full",
    "gossip_full": "full",
    "gossip_ring": "ring",
    "gossip_exp": "exp",
}


@dataclass
class RuntimeConfig:
    m: int = 16
    t_step: float = 0.19  # mean compute time per local step (s)
    t_comm: float = 0.065  # full model all-reduce incl. handshake (s)
    t_handshake: float = 0.02  # fixed latency part of any collective
    straggle_std: float = 0.0  # lognormal sigma on per-step compute
    straggle_prob: float = 0.0  # probability of a step slowing by straggle_factor
    straggle_factor: float = 4.0
    powersgd_compression: float = 243.0  # rank-1 payload reduction
    powersgd_codec: float = 0.01  # encode+decode time per step (s)
    # host-offload stream (DESIGN.md §9): bytes moved over the host link per
    # round per worker (opt-state round trips × τ + anchor slots × 1) and the
    # measured link bandwidth; 0 disables the term (plane-resident runs)
    offload_bytes_per_round: float = 0.0
    offload_gbps: float = 0.0
    seed: int = 0


@dataclass
class RuntimeResult:
    total_time: float
    compute_time: float  # mean per-worker compute over the run
    exposed_comm: float  # communication NOT hidden behind compute
    idle_time: float  # straggler-induced waiting (per live worker)
    steps: int
    # critical-path compute: the slowest worker's total compute — the floor
    # no schedule can beat (total_time ≥ compute_critical always)
    compute_critical: float = 0.0
    # rounds whose collective was skipped because no worker was live
    skipped_rounds: int = 0
    # host-link transfer NOT hidden behind the τ-step window (offload stream)
    exposed_transfer: float = 0.0

    @property
    def comm_ratio(self) -> float:
        return self.exposed_comm / max(self.compute_time, 1e-12)


def _step_times(cfg: RuntimeConfig, rng, steps: int) -> np.ndarray:
    t = np.full((steps, cfg.m), cfg.t_step)
    if cfg.straggle_std > 0:
        t *= rng.lognormal(mean=0.0, sigma=cfg.straggle_std, size=(steps, cfg.m))
    if cfg.straggle_prob > 0:
        slow = rng.random((steps, cfg.m)) < cfg.straggle_prob
        t = np.where(slow, t * cfg.straggle_factor, t)
    return t


def calibrated_config(dryrun_json, *, link_gbps: float = 40.0, base: Optional[RuntimeConfig] = None) -> RuntimeConfig:
    """A :class:`RuntimeConfig` calibrated from a production dry-run JSON
    (the reference's ``launch.dryrun``) instead of the paper's 2020 constants.

    * ``m``       — the parallel plan's worker count.
    * ``t_step``  — the roofline's per-round device time (max of compute and
      memory terms) divided by τ: what one local step actually costs on the
      modelled hardware.
    * ``t_comm``  — the measured boundary-collective payload (falling back
      to the packed plane's x-buffer bytes when the boundary probe was
      skipped) over ``link_gbps``, plus the handshake.

    ``dryrun_json`` is a path or an already-loaded result dict; ``base``
    seeds every field not derivable from the JSON (straggler knobs, seed —
    typically :meth:`repro_torch.fault.plan.FaultPlan.runtime_config` output so a
    fault plan's distributions ride on calibrated hardware constants).
    """
    if isinstance(dryrun_json, (str, os.PathLike)):
        with open(dryrun_json) as f:
            d = json.load(f)
    else:
        d = dryrun_json
    cfg = base if base is not None else RuntimeConfig()
    m = int((d.get("plan") or {}).get("workers", cfg.m))
    tau = int(d.get("tau") or 1)
    t_step = cfg.t_step
    roof = d.get("roofline") or {}
    t_round = max(float(roof.get("compute_s") or 0.0), float(roof.get("memory_s") or 0.0))
    if t_round > 0:
        t_step = t_round / max(tau, 1)
    coll_bytes = sum(float(v.get("bytes", 0)) for v in (d.get("boundary_collectives") or {}).values())
    if coll_bytes <= 0:
        coll_bytes = float((d.get("plane") or {}).get("x_buffer_bytes") or 0.0)
    t_comm = cfg.t_comm
    if coll_bytes > 0 and link_gbps > 0:
        t_comm = cfg.t_handshake + coll_bytes / (link_gbps * 1e9 / 8)
    # offloaded dry-runs carry their stream bytes + measured host-link
    # bandwidth; plane-resident JSONs leave both knobs at the base config
    off_bytes, off_gbps = cfg.offload_bytes_per_round, cfg.offload_gbps
    ob = d.get("offload") or {}
    if ob.get("enabled"):
        off_bytes = float(ob.get("stream_bytes_per_round_per_device") or 0.0)
        bw = ob.get("bandwidth") or {}
        rates = [float(bw[k]) for k in ("d2h_gbps", "h2d_gbps") if bw.get(k)]
        if rates:
            off_gbps = min(rates)
    return replace(
        cfg, m=m, t_step=t_step, t_comm=t_comm,
        offload_bytes_per_round=off_bytes, offload_gbps=off_gbps,
    )


def offload_stream_time(cfg: RuntimeConfig) -> float:
    """Seconds the host-offload stream needs per round per worker; 0 when
    the run is plane-resident (either knob unset)."""
    if cfg.offload_bytes_per_round <= 0 or cfg.offload_gbps <= 0:
        return 0.0
    return cfg.offload_bytes_per_round / (cfg.offload_gbps * 1e9)


def offload_schedule(bytes_per_round: float, gbps: float, tau: int, t_step: float) -> dict:
    """The overlap contract of the offload stream against one τ-step window,
    as a JSON-ready block (dry-run's ``offload.schedule``): exposed transfer
    is ``max(0, stream_s − τ·t_step)`` — zero (``hidden=True``) exactly when
    the window is long enough, and ``breakeven_tau`` is the smallest τ that
    hides the stream at this bandwidth and step time."""
    stream_s = bytes_per_round / (gbps * 1e9) if gbps > 0 else float("inf")
    window_s = float(tau) * float(t_step)
    exposed_s = max(0.0, stream_s - window_s)
    breakeven = int(np.ceil(stream_s / t_step)) if t_step > 0 and np.isfinite(stream_s) else None
    return dict(
        stream_bytes_per_round=float(bytes_per_round),
        link_gbps=float(gbps),
        stream_s=stream_s,
        window_s=window_s,
        exposed_s=exposed_s,
        hidden=bool(exposed_s == 0.0),
        breakeven_tau=breakeven,
    )


def _fault_round(r: int, m: int, fault_plan):
    """(live mask, comm-jitter factor) for round r; trivial without a plan."""
    if fault_plan is None:
        return np.ones(m, bool), 1.0
    return fault_plan.mask_at(r), fault_plan.comm_jitter(r)


def gossip_comm_time(cfg: RuntimeConfig, degree: int) -> float:
    """Per-round collective time for a degree-d neighbor exchange: the fixed
    handshake plus the payload term scaled by how many model copies a worker
    actually ships — degree/(m−1) of the fully-connected payload, so the
    degenerate ``full`` topology prices exactly ``t_comm``."""
    return cfg.t_handshake + (cfg.t_comm - cfg.t_handshake) * (degree / max(cfg.m - 1, 1))


def simulate(algo: str, tau: int, steps: int, cfg: RuntimeConfig, fault_plan=None, topology=None) -> RuntimeResult:
    """``fault_plan`` (:class:`repro_torch.fault.plan.FaultPlan`, optional) drives
    degraded rounds: its per-round compute factors scale the step times, its
    crash windows + straggler deadlines take workers out of barriers (the
    deadline policy — an excluded worker cannot hold the round), its network
    jitter scales each round's collective, and a rejoining worker resumes at
    the round clock (the anchor re-sync). Without a plan the clocks are the
    historical fully-live model, value for value.

    ``topology`` (:class:`repro_torch.core.topology.Topology` or a name string)
    selects the gossip barrier structure for the ``gossip_*`` algorithms;
    by default it is derived from the algorithm name over ``cfg.m`` workers.
    """
    rng = np.random.default_rng(cfg.seed)
    t = _step_times(cfg, rng, steps)
    m = cfg.m

    comm = cfg.t_comm
    if algo == "powersgd":
        comm = cfg.t_handshake + (cfg.t_comm - cfg.t_handshake) / cfg.powersgd_compression + cfg.powersgd_codec
    if algo == "sync_sgd" or algo == "powersgd":
        tau = 1

    rounds = steps // tau
    if fault_plan is not None:
        if fault_plan.m != m:
            raise ValueError(f"fault plan is over m={fault_plan.m} workers, config has m={m}")
        if rounds > 0:
            factors = np.stack([fault_plan.round_compute_factors(r) for r in range(rounds)])
            t[: rounds * tau] *= np.repeat(factors, tau, axis=0)

    compute_critical = float(t.sum(axis=0).max())  # critical-path compute
    mean_compute = float(t.sum(axis=0).mean())
    # host-offload stream: a round's window cannot close before its stream
    # lands, so each worker's segment is max(compute, stream) — the excess is
    # exposed transfer. The trailing partial segment (no boundary, partial
    # stream) is left un-stretched: conservative by < one round.
    stream_s = offload_stream_time(cfg)
    exposed_transfer = 0.0
    # the trailing steps % tau partial segment: pure local compute, no
    # boundary — every branch advances the clocks by it after its last round
    tail = t[rounds * tau :].sum(axis=0) if steps > rounds * tau else None

    if algo in ("sync_sgd", "powersgd", "local_sgd", "easgd"):
        # barrier every tau steps (over LIVE workers only), then blocking
        # collective; dead/excluded workers rejoin at the round clock
        exposed = 0.0
        idle = 0.0
        skipped = 0
        worker_clock = np.zeros(m)
        for r in range(rounds):
            seg = t[r * tau : (r + 1) * tau].sum(axis=0)
            if stream_s > 0:
                lag = np.maximum(stream_s - seg, 0.0)
                exposed_transfer += float(lag.max())
                seg = seg + lag
            live, jitter = _fault_round(r, m, fault_plan)
            arrive = worker_clock + seg
            if not live.any():
                # all-dead round: no barrier, no collective — the live path
                # (Membership.from_mask) refuses such a boundary host-side;
                # here the clocks advance by local compute and move on
                skipped += 1
                worker_clock = arrive
                continue
            barrier = arrive[live].max()
            idle += float((barrier - arrive[live]).sum()) / max(int(live.sum()), 1)
            c = comm * jitter
            exposed += c
            worker_clock = np.full(m, barrier + c)
        if tail is not None:
            worker_clock = worker_clock + tail
        total = float(worker_clock.max())
        return RuntimeResult(total, mean_compute, exposed, idle, steps, compute_critical, skipped, exposed_transfer)

    if algo in OVERLAPPED or algo in GOSSIP or topology is not None:
        # non-blocking: the collective launched at boundary r completes comm
        # seconds after every contribution exists; a worker blocks at
        # boundary r+1 only if the completion it must consume is still in
        # flight when it arrives there. The global algorithms wait on (and
        # contribute to) ALL live workers; gossip workers wait only on their
        # live in-neighbors for the round's mixing matrix, and ship a
        # degree-priced payload.
        topo = None
        if algo in GOSSIP or topology is not None:
            from repro_torch.core.topology import Topology, make_topology

            topo = topology or _GOSSIP_TOPOLOGY.get(algo, "full")
            if not isinstance(topo, Topology):
                topo = make_topology(str(topo), m)
            if topo.m != m:
                raise ValueError(f"topology is over m={topo.m} workers, config has m={m}")
            comm = gossip_comm_time(cfg, topo.degree)
        worker_clock = np.zeros(m)
        ready = np.zeros(m)  # per-worker completion time of the in-flight collective
        exposed = 0.0
        idle = 0.0
        skipped = 0
        for r in range(rounds):
            seg = t[r * tau : (r + 1) * tau].sum(axis=0)
            if stream_s > 0:
                lag = np.maximum(stream_s - seg, 0.0)
                exposed_transfer += float(lag.max())
                seg = seg + lag
            live, jitter = _fault_round(r, m, fault_plan)
            if not live.any():
                # all-dead round: nothing launched, nothing consumed; any
                # in-flight collective stays in flight for the next round
                skipped += 1
                worker_clock = worker_clock + seg
                continue
            arrive = worker_clock + seg
            # wait (only) for the previous round's collective
            stall = np.maximum(ready - arrive, 0.0)
            exposed += float(stall[live].max())
            idle += float(stall[live].mean())
            advanced = arrive + stall
            round_clock = float(advanced[live].max())
            if topo is None:
                # global collective: complete once all LIVE contributions
                # exist; excluded workers park at the round clock (re-sync)
                # and — like the live path's anchor re-sync — consume the
                # same collective as everyone else on rejoin
                ready = np.full(m, round_clock + comm * jitter)
            else:
                # per-worker neighbor-set barrier: worker i's mix completes
                # once its live in-neighbors (self included) have advanced
                nb = topo.in_mask(r) & live[None, :]
                vals = np.where(nb, advanced[None, :], -np.inf)
                recv = vals.max(axis=1)
                recv = np.where(np.isfinite(recv), recv, advanced)
                ready = np.where(live, recv + comm * jitter, ready)
            worker_clock = np.where(live, advanced, round_clock)
        if tail is not None:
            worker_clock = worker_clock + tail
        # the final boundary's collective is still in flight at the last
        # arrival: the run is not done until it lands (the last averaged
        # model does not exist before then)
        final_wait = max(0.0, float(ready.max()) - float(worker_clock.max()))
        exposed += final_wait
        total = float(worker_clock.max()) + final_wait
        return RuntimeResult(total, mean_compute, exposed, idle, steps, compute_critical, skipped, exposed_transfer)

    raise ValueError(algo)


def epoch_summary(
    algo: str, tau: int, steps_per_epoch: int, cfg: RuntimeConfig, fault_plan=None, topology=None
) -> Dict[str, float]:
    r = simulate(algo, tau, steps_per_epoch, cfg, fault_plan=fault_plan, topology=topology)
    return dict(
        algo=algo,
        tau=tau,
        epoch_time=r.total_time,
        compute=r.compute_time,
        compute_critical=r.compute_critical,
        exposed_comm=r.exposed_comm,
        exposed_transfer=r.exposed_transfer,
        comm_ratio=r.comm_ratio,
        idle=r.idle_time,
    )
