from kmcex.core import codec, murmur, occu_bin

__all__ = ["codec", "murmur", "occu_bin"]
