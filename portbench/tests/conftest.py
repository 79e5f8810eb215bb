"""pytest settings of the benchmark's own tests: the ``card`` marker, for
tests that need a CUDA card (they skip without one, deciding inside the
test)."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips on a machine without one")
