"""pytest settings of the benchmark's own tests (from the repo root:
``python -m pytest portbench/tests -q``): the marker of the tests that need
the card."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips without one")
