from instruct_jax.data.dataset import Dataset, Panel
from instruct_jax.data.synthetic import synthetic_panel

__all__ = ["Dataset", "Panel", "synthetic_panel"]
