"""Pytest settings shared by the test files: registers the ``cuda`` marker."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU and the CUDA toolkit; skips "
        "without a card (run with `python -m pytest -m cuda` on the card)")
