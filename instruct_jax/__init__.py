"""instruct_jax — Bayesian population-structure inference on accelerators.

A brand-new JAX/XLA/Pallas implementation of the InStruct model family
(Gao, Williamson & Bustamante 2007): joint inference of population
substructure (ancestry proportions Q, allele-copy assignments Z,
per-subpopulation allele frequencies P) together with selfing rates S (via
latent selfing-generation counts G) or inbreeding coefficients F, at
population or individual granularity, under uniform / normal / Dirichlet-
process priors, for diploid and tetraploid genotype data.

Unlike the sequential single-core C reference, every sampler here is a
vectorized device kernel: one MCMC step is one jitted function, the MCMC loop
is `lax.scan`, chains are a vmapped leading axis sharded over a
`jax.sharding.Mesh`, and diagnostics (Gelman-Rubin, ESS, DIC) run on-device.

Reference parity anchors are cited throughout as `<file>.c:<line>` pointing
into the upstream C sources.
"""

from instruct_jax.config import ModelSpec, Schedule, Priors
from instruct_jax.data.dataset import Dataset, Panel
from instruct_jax.data.synthetic import synthetic_panel
from instruct_jax.mcmc.driver import run_mcmc, RunResult

__version__ = "0.1.0"

__all__ = [
    "ModelSpec",
    "Schedule",
    "Priors",
    "Dataset",
    "Panel",
    "synthetic_panel",
    "run_mcmc",
    "RunResult",
    "__version__",
]
