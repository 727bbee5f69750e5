"""yalla_tpu: a JAX framework for agent-based morphogenesis models.

A from-scratch JAX/XLA/Pallas rebuild with the capabilities of the CUDA
reference library yalla (spheroid/center-based models of multicellular
morphogenesis): points with arbitrary extra fields, overdamped pairwise
dynamics v = F + <v(t-dt)> integrated with a 2nd-order Heun scheme, spin-like
polarity forces, protrusion links, proliferation with lineage tracing,
mesh-based geometry, and legacy-VTK I/O for ParaView.

Design: state is a struct-of-arrays pytree of fixed-capacity padded arrays
plus an active count; a step is a pure jitted function; forces are
elementwise jnp functions over pair blocks that run unchanged in the
all-pairs, grid, lattice, Gabriel and sweep-kernel engines; dynamic cell counts use
prefix-sum slot allocation so growth never recompiles.
"""

from .dtypes import (Float3, Float4, Po_cell, Polarity, dot_product, make_pt,
                     pt_zeros_like)
from .property import Property
from .solvers import (GabrielEngine, GenericForce, GridEngine, LatticeEngine,
                      SimulationError, Solution, SweepEngine, TileEngine,
                      friction_on_background, friction_w_neighbour,
                      heun_step, heun_steps)

__version__ = "0.1.0"
