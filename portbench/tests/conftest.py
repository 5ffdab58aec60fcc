"""The benchmark's tests: CPU tests at small sizes, and card tests
(marked ``cuda``) that skip where CUDA is absent."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips where CUDA is absent")
