from . import ring  # noqa: F401
