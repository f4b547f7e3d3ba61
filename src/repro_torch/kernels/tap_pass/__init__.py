from . import kernel, ops, ref
from .ops import tap_apply_lut, tap_ripple_add

__all__ = ["kernel", "ops", "ref", "tap_apply_lut", "tap_ripple_add"]
