from .loader import (loadbasis, list_basis_sets,  # noqa: F401
                     parse_gaussian94, register_basis_dir)
