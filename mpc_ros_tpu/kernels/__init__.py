from .roofline import (DEVICE_SPECS, DeviceSpec, StageAccount,
                       account_backward, account_forward, account_linearize,
                       account_rollout, device_spec, efficiency,
                       megakernel_accounting, solve_accounting)

__all__ = [
    "DEVICE_SPECS",
    "DeviceSpec",
    "StageAccount",
    "account_backward",
    "account_forward",
    "account_linearize",
    "account_rollout",
    "device_spec",
    "efficiency",
    "megakernel_accounting",
    "solve_accounting",
]
