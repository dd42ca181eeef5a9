from repro_torch.api.experiment import ClassificationSpec, Experiment, FitResult, TokenStream

__all__ = ["ClassificationSpec", "Experiment", "FitResult", "TokenStream"]
