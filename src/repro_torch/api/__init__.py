from repro_torch.api.experiment import ClassificationSpec, Experiment, FitResult

__all__ = ["ClassificationSpec", "Experiment", "FitResult"]
