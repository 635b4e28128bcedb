"""Repository-wide pytest settings: registers the marker of the tests that
need an NVIDIA GPU (they skip where torch.cuda.is_available() is False)."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU and the CUDA toolkit; skips "
        "where torch.cuda.is_available() is False")
