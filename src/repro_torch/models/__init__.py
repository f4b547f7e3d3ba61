"""The model stack of the port: :mod:`.model` (init, the one cast,
forward, KV cache, decode step) over :mod:`.blocks`, :mod:`.attention`,
:mod:`.mlp`, :mod:`.moe` and :mod:`.ssm`, with :mod:`.quant` for the packed
balanced-ternary MLP weights, whose products run through the packed-ternary
CUDA kernels on the card."""
from . import quant  # noqa: F401
from . import model  # noqa: F401
