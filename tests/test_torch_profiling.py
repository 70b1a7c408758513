"""The profiling helpers of ``squeezedet_torch/utils/profiling.py``
(counterparts of the JAX package's ``trace`` and
``save_device_memory_profile``), on the CPU."""

import json
import os

import pytest
import torch
from torch_threads import one_thread  # noqa: F401

from squeezedet_torch.utils import profiling


def test_trace_writes_a_chrome_trace_naming_the_matmul(tmp_path):
    logdir = str(tmp_path / "nested" / "trace")
    a, b = torch.randn(64, 32), torch.randn(32, 16)
    with profiling.trace(logdir):
        c = torch.mm(a, b)
    assert c.shape == (64, 16)
    with open(os.path.join(logdir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)


def test_trace_writes_its_trace_when_the_block_raises(tmp_path):
    logdir = str(tmp_path / "trace")
    with pytest.raises(ValueError):
        with profiling.trace(logdir):
            torch.mm(torch.ones(4, 4), torch.ones(4, 4))
            raise ValueError("inside the traced block")
    assert os.path.getsize(os.path.join(logdir, "trace.json")) > 0


def test_device_memory_profile_raises_without_cuda(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = tmp_path / "memory.pickle"
    with pytest.raises(RuntimeError, match="CUDA device"):
        profiling.save_device_memory_profile(str(path))
    assert not path.exists()


@pytest.mark.cuda
def test_device_memory_profile_on_the_card(tmp_path):
    """The snapshot holds the segment of a tensor allocated on the card."""
    import pickle
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    x = torch.empty(1 << 20, device="cuda")
    path = tmp_path / "memory.pickle"
    profiling.save_device_memory_profile(str(path))
    with open(path, "rb") as f:
        snapshot = pickle.load(f)
    assert sum(s["total_size"] for s in snapshot["segments"]) >= \
        x.numel() * 4
