from kmcex.utils.prefetch import prefetch_iterator

__all__ = ["prefetch_iterator"]
