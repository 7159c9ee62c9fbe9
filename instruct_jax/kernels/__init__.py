"""Hand-written kernels and the choice of route by platform.

The fused diploid kernels (fused_step.py, s_pop_pallas.py) are Pallas
kernels compiled through Triton.  Every other platform runs the XLA
formulation of the same updates (mcmc/updates.py, model/likelihood.py).
"""

from __future__ import annotations

from typing import Optional

import jax

# platform -> Pallas route of the fused kernels
ROUTES = {"gpu": "triton"}


def pallas_route(use_pallas: Optional[bool],
                 platform: Optional[str] = None) -> Optional[str]:
    """The Pallas route the step compiles to, or None for the XLA path.

    ``use_pallas`` None picks the platform's route where it has one; False
    always takes XLA; True demands a route and raises ``ValueError`` on a
    platform without one (interpret mode is only for tests, which ask for
    it per call)."""
    if use_pallas is False:
        return None
    platform = platform or jax.default_backend()
    route = ROUTES.get(platform)
    if route is None and use_pallas:
        raise ValueError(
            f"use_pallas=True, but platform {platform!r} has no Pallas "
            f"kernel route (routes: {ROUTES}); pass use_pallas=None or "
            f"False for the XLA path")
    return route
