"""gpvecchia_tpu: Vecchia Gaussian-process inference in JAX.

A from-scratch JAX/XLA implementation of the general Vecchia framework
(Katzfuss & Guinness), Vecchia prediction, and Vecchia-Laplace inference for
non-Gaussian data, with the capability surface of the GPvecchia R package
re-designed for accelerators: batched dense kernels, static shapes,
host-side symbolic analysis, and mesh sharding for scale-out.
"""

from .spec import VecchiaSpec, vecchia_specify
from .inference.likelihood import vecchia_likelihood, loglik_fn

__all__ = [
    "VecchiaSpec",
    "vecchia_specify",
    "vecchia_likelihood",
    "loglik_fn",
]

__version__ = "0.1.0"
