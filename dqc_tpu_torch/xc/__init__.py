from .getxc import get_xc, get_libxc   # noqa: F401
