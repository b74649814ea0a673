"""Registers the ``cuda`` marker: tests of the PyTorch port's CUDA kernels,
which run only on a machine with a CUDA device and skip elsewhere."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device (the port's hand-written "
        "kernels); skipped where none exists")
