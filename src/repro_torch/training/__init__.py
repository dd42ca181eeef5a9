"""Round-based training over the plane-resident state: τ local steps, then
the strategy's round boundary. Most callers go through
:class:`repro_torch.api.Experiment`."""
from repro_torch.training.train_loop import drain, make_round_step
from repro_torch.training.train_state import TrainState, consensus_params, make_train_state, params_view

__all__ = ["TrainState", "consensus_params", "drain", "make_round_step", "make_train_state", "params_view"]
