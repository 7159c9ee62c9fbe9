from instruct_jax.mcmc.state import McmcState, init_state
from instruct_jax.mcmc.step import build_step
from instruct_jax.mcmc.driver import run_mcmc, RunResult

__all__ = ["McmcState", "init_state", "build_step", "run_mcmc", "RunResult"]
