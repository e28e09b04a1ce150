from .pipeline import SyntheticLM, batch_iterator

__all__ = ["SyntheticLM", "batch_iterator"]
