"""cpprob_jax — a probabilistic-programming inference framework in JAX.

Brand-new implementation of the capabilities of lezcano/CPProb (reference
blueprint in SURVEY.md): models are pure JAX functions written with the
``sample`` / ``observe`` / ``predict`` idiom (``include/cpprob/cpprob.hpp``),
and inference is massively vectorized importance sampling (SIS), SMC with
distributed systematic resampling, inference compilation (CSIS) with an
in-process LSTM proposal network, plus HMC/NUTS and SVI — all jit/vmap/pjit
compiled by XLA (one NVIDIA GPU or several).
"""

from . import distributions, models, postprocess
from .core import (
    factor,
    handlers,
    metaobserve,
    observe,
    predict,
    guarded_rejection,
    rejection_sample,
    scan_sites,
    rejection_sampling,
    sample,
)
from .inference import (
    CSIS,
    DynamicCSIS,
    ImportanceResult,
    SMCResult,
    StateSpaceModel,
    hmc,
    nuts,
    particle_gibbs,
    sis,
    smc,
    smc_sampler,
    svi,
)
from .postprocess import EmpiricalDistribution, StatsPrinter

__version__ = "0.1.0"

__all__ = [
    "sample",
    "observe",
    "predict",
    "factor",
    "metaobserve",
    "rejection_sampling",
    "guarded_rejection",
    "rejection_sample",
    "scan_sites",
    "handlers",
    "distributions",
    "models",
    "postprocess",
    "sis",
    "smc",
    "smc_sampler",
    "particle_gibbs",
    "CSIS",
    "DynamicCSIS",
    "hmc",
    "nuts",
    "svi",
    "ImportanceResult",
    "SMCResult",
    "StateSpaceModel",
    "EmpiricalDistribution",
    "StatsPrinter",
]
