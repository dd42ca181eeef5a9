"""Worker meshes (counterpart of ``repro.launch.mesh``).

:func:`make_smoke_mesh` makes the worker mesh of an initialised process
group: one process a worker rank, each holding m/W rows of the plane
(:mod:`repro_torch.parallel.sharding`)::

    torch.distributed.init_process_group("nccl", init_method=..., world_size=W, rank=r)
    with mesh_context(make_smoke_mesh(W)):
        exp = Experiment(arch="qwen2-7b", workers=m).build()   # the rank's m/W rows
        res = exp.fit(rounds=8, adaptive_tau=TauController(...), faults=FaultPlan.parse("crash:1@2-5", m=m, seed=7))
        exp.evaluate()                                         # the consensus of all m workers

What runs on a mesh (ROADMAP item 10b): ``Experiment.fit``, plain, with
``faults=``, with ``adaptive_tau=`` and with both, for every strategy
(overlap_local_sgd, local_sgd, sync_sgd, easgd, cocod, delayed_avg,
sparse_anchor, powersgd and the gossip family: gossip_full, gossip_ring,
gossip_exp, gossip_pushsum/sgp), on the packed plane, per leaf
(``AlgoConfig(packed=False)``, the legacy ``Algorithm`` shims, an optimizer
with no packed step) and host-offloaded (``AlgoConfig(offload=True)``: each
rank's optimizer state on its own pinned host stacks); the readers
``consensus()``, ``consensus_plane()``, ``anchor_plane()``, ``evaluate()``
and ``serve()``; ``checkpoint.save`` (rank 0 writes the one-process file)
and ``checkpoint.restore`` (each rank keeps its rows; ``elastic=True``
moves a state between W and m). Every rank makes the same calls and ends
with the same losses, τ schedule, fault log, anchor and readers.

The reference's production mesh (``make_production_mesh``, the v5e pod)
and its TPU constants wait for ROADMAP Queue 1 item 10d; within-worker
sharding (fsdp, tensor > 1) for item 10c.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.config.base import ParallelPlan
from repro_torch.parallel.sharding import WorkerMesh, logical_mesh


def make_smoke_mesh(workers: int = 2, fsdp: int = 1, tensor: int = 1, *, device="cuda",
                    backend: Optional[str] = None) -> WorkerMesh:
    """The mesh of ``workers`` ranks over the default process group: NCCL
    on the rank's card (``device="cuda"``: the card of ``LOCAL_RANK``),
    gloo with ``device="cpu"``. ``backend`` names another (gloo on CUDA
    tensors lets two ranks share one card); nothing picks it on its own."""
    return logical_mesh(ParallelPlan(workers, fsdp, tensor), device=device, backend=backend)
