"""Checkpoints of the train state (counterpart of
``squeezedet_tpu/checkpoint/manager.py``, same filesystem contract).

A checkpoint is a directory ``<train_dir>/model.ckpt-<step>/`` holding
``state.pt``: ``torch.save`` of ``{"params": backbone state_dict,
"opt_state": Momentum.state_dict(), "step": int}``, all on the CPU.  Each
save writes into a temporary name and ``os.rename``s it into place, so a
poller (the eval daemon) never sees a half-written step: :func:`latest_step`
matches only the anchored ``model.ckpt-<step>`` names.  Retention
(``max_to_keep``) prunes before each save by renaming a step out of that
pattern first and deleting the rename, with its ``sampler.ckpt-<step>``
files matched by exact step.
"""

from __future__ import annotations

import os
import re
import shutil
import threading
from typing import Any, Optional

import torch

_STEP_RE = re.compile(r"^(?:model\.ckpt-|)(\d+)$")
STATE_FILE = "state.pt"


def latest_step(directory: str) -> Optional[int]:
    """Largest finalized checkpoint step in ``directory`` (None if none).

    Safe against a concurrent pruner: if a listed step vanished before
    its isdir check, the listing is stale and is taken again rather than
    reporting the directory empty.
    """
    if not os.path.isdir(directory):
        return None
    for _ in range(8):
        steps = []
        raced = False
        for name in os.listdir(directory):
            m = _STEP_RE.match(name)
            if m:
                if os.path.isdir(os.path.join(directory, name)):
                    steps.append(int(m.group(1)))
                else:
                    raced = True
        if steps or not raced:
            break
    return max(steps) if steps else None


def all_steps(directory: str) -> list:
    """Every finalized checkpoint step in ``directory``, ascending."""
    if not os.path.isdir(directory):
        return []
    steps = []
    for name in os.listdir(directory):
        m = _STEP_RE.match(name)
        if m and os.path.isdir(os.path.join(directory, name)):
            steps.append(int(m.group(1)))
    return sorted(steps)


def _to_host(tree):
    """A copy of ``tree`` with every tensor cloned to the CPU: the train
    step updates the live tensors in place while a save is writing."""
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    return tree


def _check_shapes(restored, like, path=""):
    """Raise if a restored tree's tensors differ in shape from ``like``'s."""
    if isinstance(like, dict):
        if not isinstance(restored, dict) or set(restored) != set(like):
            raise ValueError(
                "checkpoint/model shape mismatch at {}: checkpoint has "
                "keys {}, model expects {} — wrong --net or resolution for "
                "this checkpoint?".format(
                    path or "/", sorted(restored) if isinstance(
                        restored, dict) else type(restored).__name__,
                    sorted(like)))
        for k in like:
            _check_shapes(restored[k], like[k], path + "/" + str(k))
    elif isinstance(like, torch.Tensor):
        if not isinstance(restored, torch.Tensor) or \
                restored.shape != like.shape:
            raise ValueError(
                "checkpoint/model shape mismatch at {}: checkpoint has {}, "
                "model expects {} — wrong --net or resolution for this "
                "checkpoint?".format(
                    path, tuple(getattr(restored, "shape", ())),
                    tuple(like.shape)))


class CheckpointManager:
    """Save and restore train-state trees keyed by step.

    ``max_to_keep`` bounds the directory like the reference Saver's
    default of 5: before each save, all but the newest ``max_to_keep - 1``
    finalized steps (at least 1) are pruned, so with the new step the
    directory holds ``max_to_keep``.  ``None`` or 0 keeps everything.
    """

    def __init__(self, directory: str, max_to_keep: Optional[int] = None):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep or 0
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, "model.ckpt-{}".format(step))

    def prune(self, keep_newest: int) -> list:
        """Delete all but the newest ``keep_newest`` finalized steps (and
        their sampler snapshots).  Returns the pruned steps."""
        # residue of a prune interrupted mid-rmtree
        for name in os.listdir(self.directory):
            if ".pruning" in name:
                shutil.rmtree(os.path.join(self.directory, name),
                              ignore_errors=True)
        steps = all_steps(self.directory)
        pruned = steps[:-keep_newest] if keep_newest > 0 else steps
        for step in pruned:
            path = self._path(step)
            doomed = "{}.pruning.{}".format(path, os.getpid())
            try:
                os.rename(path, doomed)  # atomic: unmatches latest_step
            except OSError:  # a concurrent pruner won
                continue
            shutil.rmtree(doomed, ignore_errors=True)
            # exact step only: step 1000 must not claim sampler.ckpt-10000
            sampler_re = re.compile(
                r"^sampler\.ckpt-{}(\.p\d+)?\.npz$".format(step))
            for name in os.listdir(self.directory):
                if sampler_re.match(name):
                    try:
                        os.remove(os.path.join(self.directory, name))
                    except FileNotFoundError:
                        pass
        return pruned

    def _write(self, step: int, tree) -> None:
        path = self._path(step)
        tmp = "{}.tmp.{}".format(path, os.getpid())
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(tree, os.path.join(tmp, STATE_FILE))
        if os.path.isdir(path):  # a re-save of the same step
            shutil.rmtree(path)
        os.rename(tmp, path)

    def _write_in_background(self, step: int, tree) -> None:
        try:
            self._write(step, tree)
        except BaseException as e:  # re-raised by wait_until_finished
            self._error = e

    def save(self, step: int, tree: Any, wait: bool = True) -> str:
        """Write ``model.ckpt-<step>``.  The tree's tensors are copied to
        the CPU before this returns; with ``wait=False`` the file write
        runs on a background thread, overlapping the next train steps
        (call :meth:`wait_until_finished` before exit)."""
        self.wait_until_finished()
        if self.max_to_keep:
            self.prune(max(self.max_to_keep - 1, 1))
        host = _to_host(tree)
        if wait:
            self._write(step, host)
        else:
            self._thread = threading.Thread(
                target=self._write_in_background, args=(step, host),
                daemon=True)
            self._thread.start()
        return self._path(step)

    def wait_until_finished(self) -> None:
        """Block until a background save has finished; raise its error."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            error, self._error = self._error, None
            raise RuntimeError("checkpoint save failed") from error

    def _load(self, step: int):
        return torch.load(os.path.join(self._path(step), STATE_FILE),
                          map_location="cpu", weights_only=True)

    def restore(self, step: int, like: Any) -> Any:
        """The saved tree of ``step``, checked against ``like``'s shapes."""
        restored = self._load(step)
        _check_shapes(restored, like)
        return restored

    def restore_params(self, step: int, params_like: Any) -> Any:
        """Only the ``params`` (backbone state_dict) of a saved state, for
        inference jobs that build no optimizer."""
        restored = self._load(step)["params"]
        _check_shapes(restored, params_like, "/params")
        return restored

    def restore_latest(self, like: Any):
        """Returns (step, tree) or (None, None)."""
        step = latest_step(self.directory)
        if step is None:
            return None, None
        return step, self.restore(step, like)
