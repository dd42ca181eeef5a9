"""Fault tolerance (counterpart of ``repro.fault``): deterministic fault
plans, live-worker membership, and the host-side injection harness."""
from repro_torch.fault.harness import FaultHarness, resync_from_anchor
from repro_torch.fault.membership import Membership, from_mask, full
from repro_torch.fault.plan import FaultPlan

__all__ = ["FaultHarness", "FaultPlan", "Membership", "from_mask", "full", "resync_from_anchor"]
