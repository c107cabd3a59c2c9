from .device import resolve_device, set_f32_numerics  # noqa: F401
