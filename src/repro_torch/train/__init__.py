from . import checkpoint, compression, optimizer, runtime, train_step  # noqa
