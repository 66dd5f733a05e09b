"""Analysis: roofline terms on a chip (TPU v5e for parity with the JAX
package, the H100 the port runs on) and the analytic parameter and FLOP
counts of a model config. `analysis.bounds` holds each LM kernel's work,
bytes and bound (chip_smoke's bounds and the meta lanes' bookings);
`analysis.count` counts a step run on the meta device (the dry run)."""
from .flops import active_params, model_flops_cell, total_params
from .roofline import (H100, V5E, Chip, CollectiveStats, Roofline,
                       from_counts, model_flops, parse_collectives)

__all__ = ["active_params", "model_flops_cell", "total_params", "H100",
           "V5E", "Chip", "CollectiveStats", "Roofline", "from_counts",
           "model_flops", "parse_collectives"]
