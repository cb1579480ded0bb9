from .base import BaseXC, HFExchangeXC, LRHFExchangeXC  # noqa: F401
from .getxc import get_xc, get_libxc    # noqa: F401
from .custom import CustomXC            # noqa: F401
