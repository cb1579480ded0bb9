"""Collection order: the tests of the PyTorch/CUDA port run first.

The whole suite is longer than the time it is given, and files are collected
alphabetically, so `tests/test_torch_*.py` would come after almost everything
else and might never be reached. Moving them to the front keeps every other
test in its order.
"""


def pytest_collection_modifyitems(items):
    def is_port(item):
        name = item.path.name if hasattr(item, "path") else ""
        return name.startswith("test_torch_") and item.path.parent.name == "tests"

    port = [it for it in items if is_port(it)]
    rest = [it for it in items if not is_port(it)]
    items[:] = port + rest
