from .pipeline import MarkovLMDataset, SyntheticDataset, make_dataset

__all__ = ["SyntheticDataset", "MarkovLMDataset", "make_dataset"]
