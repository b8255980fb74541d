from .milp import (
    InfeasibleError,
    ScheduleResult,
    assign_layers,
    assign_layers_and_select_devices,
)

__all__ = ["assign_layers", "assign_layers_and_select_devices", "ScheduleResult", "InfeasibleError"]
