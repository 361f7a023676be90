"""Analysis of the port's programs: analytic FLOPs (``accounting``) and
what one rank's program counts as it runs (``op_cost``)."""
from . import accounting, op_cost

__all__ = ["accounting", "op_cost"]
