from . import config, exceptions  # noqa: F401
