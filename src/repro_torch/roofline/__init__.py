"""Roofline analysis from dry-run records and the analytic cost model
(the port of the reference's ``repro.roofline``)."""

from .analysis import HW, analyse, load_records, model_flops, roofline_row
from .flops import cell_bytes, cell_flops

__all__ = ["HW", "analyse", "load_records", "model_flops", "roofline_row",
           "cell_bytes", "cell_flops"]
