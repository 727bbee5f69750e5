"""Observability + checkpointing utilities.

The reference's only instrumentation is the wall-clock report in
``Vtk_output``'s destructor (``include/vtk.cuh:75-91``) and
VTK files doubling as checkpoints.  The rebuild keeps both (see
``vtkio.py``) and adds strict upgrades: a step-rate tracker, an optional
``jax.profiler`` trace context, native array checkpoints, and runtime
capacity checks (the analogue of the reference's device asserts).
"""
from .cache import enable_compilation_cache
from .checkpoint import load_solution, save_solution
from .profiling import StepTimer, trace

__all__ = ["StepTimer", "trace", "save_solution", "load_solution",
           "enable_compilation_cache"]
