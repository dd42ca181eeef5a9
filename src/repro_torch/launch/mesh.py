"""Worker meshes (counterpart of ``repro.launch.mesh``).

:func:`make_smoke_mesh` makes the (worker, fsdp) mesh of an initialised
process group: one process a rank, W·F of them, global rank w·F + f the
worker index w and fsdp index f (the reference's device order). Each rank
holds m/W rows of the plane, cut to column slice f when F > 1, and 1/(W·F)
of the anchor (:mod:`repro_torch.parallel.sharding`)::

    torch.distributed.init_process_group("nccl", init_method=..., world_size=W * F, rank=r)
    with mesh_context(make_smoke_mesh(W, F)):
        exp = Experiment(arch="qwen2-7b", workers=m).build()   # the rank's share of m/W rows
        res = exp.fit(rounds=8, adaptive_tau=TauController(...), faults=FaultPlan.parse("crash:1@2-5", m=m, seed=7))
        exp.evaluate()                                         # the consensus of all m workers

What runs on a mesh (ROADMAP items 10b and 10c's first part):
``Experiment.fit``, plain, with ``faults=``, with ``adaptive_tau=`` and
with both; the readers ``consensus()``, ``consensus_plane()``,
``anchor_plane()``, ``evaluate()`` and ``serve()``; ``checkpoint.save``
(global rank 0 writes the one-process file) and ``checkpoint.restore``
(each rank keeps its share; ``elastic=True`` moves a state between meshes
and m). At F = 1: every strategy (overlap_local_sgd, local_sgd, sync_sgd,
easgd, cocod, delayed_avg, sparse_anchor, powersgd and the gossip family:
gossip_full, gossip_ring, gossip_exp, gossip_pushsum/sgp), on the packed
plane, per leaf (``AlgoConfig(packed=False)``, the legacy ``Algorithm``
shims, an optimizer with no packed step) and host-offloaded
(``AlgoConfig(offload=True)``). At F > 1: the packed resident plane with
every strategy whose boundary is elementwise (all but sparse_anchor and
powersgd). Every rank makes the same calls and ends with the same losses,
τ schedule, fault log, anchor and readers.

Still raising, naming ROADMAP item 10c's second part: tensor > 1, and with
F > 1 MoE segments, sparse_anchor, PowerSGD, the per-leaf path and
offload. The reference's production mesh (``make_production_mesh``, the
v5e pod) and its TPU constants wait for item 10d.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.config.base import ParallelPlan
from repro_torch.parallel.sharding import WorkerMesh, logical_mesh


def make_smoke_mesh(workers: int = 2, fsdp: int = 1, tensor: int = 1, *, device="cuda",
                    backend: Optional[str] = None) -> WorkerMesh:
    """The mesh of ``workers`` × ``fsdp`` ranks over the default process
    group (``tensor`` > 1 raises): NCCL on the rank's card
    (``device="cuda"``: the card of ``LOCAL_RANK``), gloo with
    ``device="cpu"``. ``backend`` names another (gloo on CUDA tensors lets
    ranks share one card); nothing picks it on its own."""
    return logical_mesh(ParallelPlan(workers, fsdp, tensor), device=device, backend=backend)
