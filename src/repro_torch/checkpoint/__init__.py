from repro_torch.checkpoint.checkpointer import restore, save

__all__ = ["restore", "save"]
