"""The roofline of the port: the H100's peaks, stated once
(``analysis.HW_H100``), a kernel's bound (``kernel_bound``), the three
terms of a step (``RooflineTerms``), its model FLOPs and analytic bytes,
and the collective tally; ``report`` turns the dry run's records into
tables."""
from .analysis import (
    HW_H100,
    CollectiveTally,
    RooflineTerms,
    kernel_bound,
    measured_mfu,
    model_flops,
)

__all__ = [
    "HW_H100",
    "CollectiveTally",
    "RooflineTerms",
    "kernel_bound",
    "measured_mfu",
    "model_flops",
]
