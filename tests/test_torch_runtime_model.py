"""The port's runtime model and τ schedule (``repro_torch.core.runtime_model``,
``repro_torch.control.schedule``, ``FaultPlan.runtime_config``) against the
JAX package's, on the CPU.

Both are pure numpy over the same inputs (configs, fault plans from the
same seed, topologies by name), so the bound is **exact equality**: every
field of every result, every key of every JSON block.
"""
import dataclasses

import numpy as np
import pytest

from repro.control import TauController as JTauController
from repro.control import schedule as jschedule
from repro.core import runtime_model as jrm
from repro.core.topology import make_topology as jmake_topology
from repro.fault.plan import FaultPlan as JFaultPlan
from repro_torch.control import TauController, per_tau_costs, runtime_algo, schedule_block, simulate_trajectory
from repro_torch.core import runtime_model as rm
from repro_torch.core.topology import make_topology
from repro_torch.fault import FaultPlan

ALGOS = sorted(set(jrm.BLOCKING) | set(jrm.OVERLAPPED) | set(jrm.GOSSIP))
STEPS = 24
# the paper's constants (tests/test_runtime_model.py), a straggler config,
# and a host-offload stream that the window does not always hide
CONFIGS = {
    "paper": dict(m=16, t_step=4.6 / STEPS, t_comm=1.5 / STEPS, t_handshake=0.02),
    "straggler": dict(m=16, t_step=0.19, t_comm=0.0625, straggle_std=0.2, straggle_prob=0.05, straggle_factor=5.0,
                      seed=3),
    "offload": dict(m=16, t_step=0.05, offload_bytes_per_round=3e9, offload_gbps=25.0, seed=1),
}
# crashes with and without a rejoin, a slow worker, compute jitter, network jitter
FAULT_SPECS = ("crash:1@2-5,slow:2x4", "crash:3@1,std:0.2,jitter:0.3", "prob:0.1@3,jitter:0.5,deadline:2.5")


def _pair_cfg(name):
    return rm.RuntimeConfig(**CONFIGS[name]), jrm.RuntimeConfig(**CONFIGS[name])


def _same(a, b):
    return dataclasses.asdict(a) == dataclasses.asdict(b)


@pytest.mark.parametrize("tau", [1, 2, 8, 24])
@pytest.mark.parametrize("algo", ALGOS)
def test_simulate_equals_reference(algo, tau):
    """Every algorithm at every τ, each config, with a trailing partial
    segment (steps % τ ≠ 0) and without."""
    for name in CONFIGS:
        cfg, jcfg = _pair_cfg(name)
        for steps in (STEPS, 4 * STEPS + 5):
            got, want = rm.simulate(algo, tau, steps, cfg), jrm.simulate(algo, tau, steps, jcfg)
            assert _same(got, want), (name, steps, got, want)
            assert got.comm_ratio == want.comm_ratio
            assert rm.epoch_summary(algo, tau, steps, cfg) == jrm.epoch_summary(algo, tau, steps, jcfg)


@pytest.mark.parametrize("spec", FAULT_SPECS)
@pytest.mark.parametrize("algo", ALGOS)
def test_simulate_under_a_fault_plan_equals_reference(algo, spec):
    """Crash windows, stragglers, deadlines and network jitter drive the
    clocks the same way; each plan's ``runtime_config`` on both sides."""
    plan, jplan = FaultPlan.parse(spec, m=8, seed=7), JFaultPlan.parse(spec, m=8, seed=7)
    cfg, jcfg = plan.runtime_config(), jplan.runtime_config()
    assert _same(cfg, jcfg)
    for tau in (1, 3):
        got = rm.simulate(algo, tau, 40, cfg, fault_plan=plan)
        want = jrm.simulate(algo, tau, 40, jcfg, fault_plan=jplan)
        assert _same(got, want), (tau, got, want)


def test_all_dead_round_and_plan_mismatch_equal_reference():
    plan, jplan = FaultPlan(m=2, crashes=((0, 1, 2), (1, 1, 2))), JFaultPlan(m=2, crashes=((0, 1, 2), (1, 1, 2)))
    cfg, jcfg = rm.RuntimeConfig(m=2, t_step=1.0, t_comm=0.5, t_handshake=0.0), jrm.RuntimeConfig(
        m=2, t_step=1.0, t_comm=0.5, t_handshake=0.0)
    for algo in ("local_sgd", "overlap_local_sgd", "gossip_ring"):
        got, want = rm.simulate(algo, 1, 4, cfg, fault_plan=plan), jrm.simulate(algo, 1, 4, jcfg, fault_plan=jplan)
        assert _same(got, want) and got.skipped_rounds == 1
    with pytest.raises(ValueError, match="m=2"):
        rm.simulate("local_sgd", 1, 4, rm.RuntimeConfig(m=4), fault_plan=plan)
    with pytest.raises(ValueError):
        rm.simulate("nope", 1, 4, cfg)


@pytest.mark.parametrize("topology", ["full", "ring", "exp"])
@pytest.mark.parametrize("algo", ["overlap_local_sgd", "gossip_pushsum", "gossip_ring"])
def test_simulate_with_a_topology_equals_reference(algo, topology):
    """An explicit topology, by name and as an object (the port's and the
    reference's own), prices the gossip barrier the same way."""
    cfg, jcfg = _pair_cfg("straggler")
    for steps in (32, 35):
        want = jrm.simulate(algo, 4, steps, jcfg, topology=topology)
        assert _same(rm.simulate(algo, 4, steps, cfg, topology=topology), want)
        got = rm.simulate(algo, 4, steps, cfg, topology=make_topology(topology, 16))
        assert _same(got, jrm.simulate(algo, 4, steps, jcfg, topology=jmake_topology(topology, 16)))
    for degree in (0, 1, 2, 15):
        assert rm.gossip_comm_time(cfg, degree) == jrm.gossip_comm_time(jcfg, degree)


DRYRUNS = [
    dict(plan=dict(workers=32, fsdp=4, tensor=2), tau=4, roofline=dict(compute_s=0.8, memory_s=0.4),
         boundary_collectives={"all-reduce": dict(count=2, bytes=4e9), "all-gather": dict(count=1, bytes=1e9)}),
    dict(plan=dict(workers=8), tau=1, roofline={}, plane=dict(x_buffer_bytes=1e9)),
    dict(plan=dict(workers=4), tau=2, roofline=dict(compute_s=0.1, memory_s=0.3),
         offload=dict(enabled=True, stream_bytes_per_round_per_device=2e9,
                      bandwidth=dict(d2h_gbps=20.0, h2d_gbps=24.0))),
    dict(tau=None, offload=dict(enabled=False, stream_bytes_per_round_per_device=5e9)),
]


@pytest.mark.parametrize("case", range(len(DRYRUNS)))
@pytest.mark.parametrize("link_gbps", [40.0, 100.0, 0.0])
def test_calibrated_config_equals_reference(case, link_gbps, tmp_path):
    """From a dict and from a file; on the default base and on a fault
    plan's ``runtime_config``."""
    import json

    d = DRYRUNS[case]
    path = tmp_path / "dryrun.json"
    path.write_text(json.dumps(d))
    for src in (d, str(path)):
        got, want = rm.calibrated_config(src, link_gbps=link_gbps), jrm.calibrated_config(src, link_gbps=link_gbps)
        assert _same(got, want)
        assert rm.offload_stream_time(got) == jrm.offload_stream_time(want)
    base = FaultPlan.parse("crash:1@2-5", m=4, seed=9).runtime_config()
    jbase = JFaultPlan.parse("crash:1@2-5", m=4, seed=9).runtime_config()
    got = rm.calibrated_config(d, link_gbps=link_gbps, base=base)
    want = jrm.calibrated_config(d, link_gbps=link_gbps, base=jbase)
    assert _same(got, want)
    assert _same(FaultPlan(m=got.m, seed=5).runtime_config(base=got), JFaultPlan(m=want.m, seed=5).runtime_config(base=want))


@pytest.mark.parametrize("gbps", [0.0, 12.5, 40.0])
@pytest.mark.parametrize("tau", [1, 2, 8, 24])
def test_offload_schedule_equals_reference(tau, gbps):
    for nbytes, t_step in ((0.0, 0.19), (3e9, 0.05), (9.9e9, 0.45)):
        assert rm.offload_schedule(nbytes, gbps, tau, t_step) == jrm.offload_schedule(nbytes, gbps, tau, t_step)


def test_runtime_config_of_a_plan_zeroes_its_own_stragglers():
    """``FaultPlan.runtime_config`` no longer raises: the plan's m and seed,
    the config's straggler knobs zeroed, a base's hardware constants kept."""
    plan = FaultPlan.parse("crash:1@2-5,std:0.4", m=6, seed=11)
    base = rm.RuntimeConfig(t_step=0.3, t_comm=0.2, straggle_std=0.5, straggle_prob=0.2)
    cfg = plan.runtime_config(base=base)
    assert (cfg.m, cfg.seed, cfg.straggle_std, cfg.straggle_prob, cfg.t_step, cfg.t_comm) == (6, 11, 0.0, 0.0, 0.3, 0.2)
    assert _same(plan.runtime_config(), JFaultPlan.parse("crash:1@2-5,std:0.4", m=6, seed=11).runtime_config())


STRATEGIES = ["overlap_local_sgd", "local_sgd", "sync_sgd", "easgd", "cocod", "powersgd", "delayed_avg",
              "sparse_anchor", "gossip_pushsum", "gossip_full", "gossip_ring", "gossip_exp", "unknown_name"]


def test_runtime_algo_equals_reference():
    assert [runtime_algo(s) for s in STRATEGIES] == [jschedule.runtime_algo(s) for s in STRATEGIES]


COMPOSED = dict(
    tau=2,
    parts={"block:mlp": dict(mult=4.0, flops=7.0, bytes=3.0, coll=0.0),
           "embed_head": dict(mult=2.0, flops=1.5, bytes=0.25, coll=0.0),
           "boundary": dict(mult=1.0, flops=0.1, bytes=0.2, coll=5.0)},
)


def test_per_tau_costs_equal_reference():
    taus = [1, 2, 3, 8, 24]
    assert per_tau_costs(COMPOSED, taus) == jschedule.per_tau_costs(COMPOSED, taus)


CTRLS = [dict(tau=2, tau_min=1, tau_max=32), dict(tau=4, tau_min=1, tau_max=32, lo=0.01, hi=0.05),
         dict(tau=1, tau_min=1, tau_max=8, lo=0.05, hi=0.5, warmup_rounds=2, cooldown_rounds=1)]


@pytest.mark.parametrize("ctrl", range(len(CTRLS)))
def test_simulate_trajectory_equals_reference(ctrl):
    kw = CTRLS[ctrl]
    for r0, spec in ((None, None), (0.3, None), (None, "crash:1@2-5,slow:2x4")):
        plan = None if spec is None else FaultPlan.parse(spec, m=16, seed=0)
        jplan = None if spec is None else JFaultPlan.parse(spec, m=16, seed=0)
        got = simulate_trajectory(TauController(**kw), 30, r0=r0, fault_plan=plan)
        want = jschedule.simulate_trajectory(JTauController(**kw), 30, r0=r0, fault_plan=jplan)
        assert got == want


@pytest.mark.parametrize("strategy", STRATEGIES[:-1])
def test_schedule_block_equals_reference(strategy):
    """The dry-run's ``tau_schedule`` block: the default config, a fault
    plan's, an explicit config and composed costs."""
    for kw in CTRLS:
        got = schedule_block(strategy, TauController(**kw), rounds=20)
        assert got == jschedule.schedule_block(strategy, JTauController(**kw), rounds=20)
    spec = "crash:1@2-5,jitter:0.2"
    got = schedule_block(strategy, TauController(**CTRLS[0]), rounds=12, fault_plan=FaultPlan.parse(spec, m=16, seed=0),
                         composed=COMPOSED)
    want = jschedule.schedule_block(strategy, JTauController(**CTRLS[0]), rounds=12,
                                    fault_plan=JFaultPlan.parse(spec, m=16, seed=0), composed=COMPOSED)
    assert got == want and [t["decision"] for t in got["trajectory"]][2:6] == ["fault_hold"] * 4
    cfg, jcfg = _pair_cfg("straggler")
    got = schedule_block(strategy, TauController(**CTRLS[1]), rounds=10, rt=cfg, r0=0.02)
    assert got == jschedule.schedule_block(strategy, JTauController(**CTRLS[1]), rounds=10, rt=jcfg, r0=0.02)


def test_runtime_modules_import_no_jax():
    import subprocess
    import sys
    import textwrap
    from pathlib import Path

    src = Path(__file__).resolve().parents[1] / "src"
    code = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {str(src)!r})
        sys.modules["jax"] = None
        from repro_torch.control import TauController, schedule_block
        from repro_torch.core.runtime_model import simulate, RuntimeConfig
        from repro_torch.fault import FaultPlan
        plan = FaultPlan.parse("crash:1@2-5", m=4, seed=1)
        print(simulate("overlap_local_sgd", 2, 16, plan.runtime_config(), fault_plan=plan).total_time > 0)
        print(len(schedule_block("local_sgd", TauController(), rounds=5)["trajectory"]))
        assert not any(k == "repro" or k.startswith("repro.") for k in sys.modules)
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["True", "5"]
