"""Seeded random numbers, the counterpart of ``nd4js_tpu/rand/``."""
from .rng import RNG, rand_normal, rand_ortho

__all__ = ["RNG", "rand_normal", "rand_ortho"]
