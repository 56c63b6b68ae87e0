"""cstone: distributed octrees for particle simulations in JAX.

A JAX/XLA/Pallas re-design of the capabilities of cornerstone-octree
(reference: github.com/sebkelle1/cornerstone-octree): 3D Morton + Hilbert
space-filling-curve keys (32/64-bit), cornerstone linear octree build
(local and mesh-global), locally-essential focused octrees, halo discovery
via collision detection, fixed-radius neighbor search, and particle/halo
exchange over a jax.sharding.Mesh — unified behind a single `Domain` class.

Design:
  - all hot paths are jittable, static-shaped and vectorized over whole
    arrays
  - dynamic sizes (tree nodes, particle counts) are carried as
    capacity-padded arrays plus validity counts
  - distribution uses jax collectives (psum/all_gather/all_to_all/ppermute)
    instead of MPI point-to-point

64-bit SFC keys require jax x64 mode; we enable it at import. All floating
point arrays remain explicitly float32 by default (float64 is never
created unless the user asks for it).
"""

import jax

jax.config.update("jax_enable_x64", True)

from .sfc.box import Box, IBox, OPEN, PERIODIC, FIXED, make_box  # noqa: E402

__version__ = "0.1.0"

__all__ = [
    "Box",
    "IBox",
    "OPEN",
    "PERIODIC",
    "FIXED",
    "make_box",
]
