from .parser import parse_moldesc  # noqa: F401
