from .pipeline import DataConfig, SyntheticDataset, batch_spec

__all__ = ["DataConfig", "SyntheticDataset", "batch_spec"]
