"""mpc_ros_tpu — batched NMPC trajectory-optimization framework in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of the ROS C++
reference `OkDoky/mpc_ros` (differential-drive NMPC path tracking): batched
SQP/iLQR with Riccati factorization replaces CppAD+Ipopt; vmap/shard_map over
scenario batches replaces the single-solve CPU loop; a typed config and
lifecycle planner API replace dynamic_reconfigure and nav_core plumbing.
"""

from .config import MPCParams, SolverConfig, PlannerConfig, PlannerLimits
from .config_io import (config_from_dict, config_to_dict, load_config,
                        save_config)

__version__ = "0.1.0"

__all__ = [
    "MPCParams",
    "SolverConfig",
    "PlannerConfig",
    "PlannerLimits",
    "config_from_dict",
    "config_to_dict",
    "load_config",
    "save_config",
]
