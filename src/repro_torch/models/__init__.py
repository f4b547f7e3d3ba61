"""Model-side helpers of the port.  So far: :mod:`.quant`, the packed
balanced-ternary MLP weights; the model stack comes later (ROADMAP queue 1,
item 8)."""
from . import quant  # noqa: F401
