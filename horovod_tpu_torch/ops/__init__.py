from . import batch_norm, flash_attention  # noqa: F401
