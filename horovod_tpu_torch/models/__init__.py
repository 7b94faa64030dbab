from . import convert, transformer  # noqa: F401
