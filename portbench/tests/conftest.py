import torch


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA GPU; skips where "
        "torch.cuda.is_available() is False")
    torch.set_num_threads(min(4, torch.get_num_threads()))
