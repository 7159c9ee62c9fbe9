from instruct_jax.model import likelihood

__all__ = ["likelihood"]
