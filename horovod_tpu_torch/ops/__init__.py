from . import flash_attention  # noqa: F401
