"""Interior-point methods (HSD, MPC) over batch-first tensors."""

from .batch import (batched_hsd_resolve, batched_hsd_solve,
                    batched_mpc_solve, stack_lps_host)
from .data import LPData, lp_data_from_problem, make_lp_data
from .graph import clear_device_programs
from .hsd import HSDOptions, HSDState, hsd_solve, hsd_solve_device
from .mpc import MPCOptions, mpc_solve, mpc_solve_device
from .point import Point, Residuals

__all__ = [
    "LPData",
    "lp_data_from_problem",
    "make_lp_data",
    "Point",
    "Residuals",
    "HSDOptions",
    "HSDState",
    "hsd_solve",
    "hsd_solve_device",
    "MPCOptions",
    "mpc_solve",
    "mpc_solve_device",
    "clear_device_programs",
    "batched_hsd_solve",
    "batched_hsd_resolve",
    "batched_mpc_solve",
    "stack_lps_host",
]
