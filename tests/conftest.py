"""Shared pytest settings: registers the marker for tests that need a card."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU with nvcc (the hand kernels); skipped elsewhere")
