from instruct_jax.samplers.potential import MarginalModel
from instruct_jax.samplers.hmc import run_hmc
from instruct_jax.samplers.svi import run_svi
from instruct_jax.samplers.smc import run_smc

__all__ = ["MarginalModel", "run_hmc", "run_svi", "run_smc"]
