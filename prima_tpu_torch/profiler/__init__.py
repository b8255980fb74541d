from .device import DeviceProfile, profile_device, print_device_props
from .model_cost import ModelCost, model_cost_from_gguf, model_cost_from_config

__all__ = [
    "DeviceProfile", "profile_device", "print_device_props",
    "ModelCost", "model_cost_from_gguf", "model_cost_from_config",
]
