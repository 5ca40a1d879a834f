"""Fault-tolerant checkpoints: atomic, async, crc-verified (counterpart of
``repro/checkpoint/ckpt.py``, in the same on-disk format, so a checkpoint
written by either package restores in the other).

Layout:  <dir>/step_<N>/
            manifest.json      step, leaves (path, file, shape, logical
                               dtype, crc32) and metadata
            <leaf-path>.npy    one file a leaf, named "__".join(path)
         <dir>/step_<N>.COMMIT   written last: restart-safe atomicity

A step is written as ``step_<N>.tmp`` and renamed before its COMMIT
marker. Leaf paths follow ``jax.tree_util.tree_flatten_with_path``
(``models/module.py:tree_paths``). Every leaf carries the crc32 of its
on-disk bytes, verified on restore. numpy has no bf16 or fp8: such a leaf
is stored as its raw uint16 / uint8 view with the logical dtype in the
manifest, and restores as a CPU tensor of that torch dtype; every other
leaf restores as a numpy array, or, with ``device=``, every leaf as a
tensor on that device.

``restore_checkpoint(step=None)`` and ``latest_step`` walk committed steps
newest first and skip torn or corrupt ones with a warning; an explicit
``step`` raises on any failure. ``CheckpointManager`` copies every leaf to
the host before its write thread starts (a copy even of CPU tensors: the
round engine updates its residual pools and params in place), keeps the
newest ``keep`` steps, and re-raises a background failure on ``wait()``
or the next ``save()``.
"""
from __future__ import annotations

import json
import logging
import os
import shutil
import threading
import zlib
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.models.module import tree_paths

# logical dtype -> (torch dtype, the raw on-disk numpy view, and the
# integer type of that width that both numpy and torch have)
_RAW_VIEW = {"bfloat16": (torch.bfloat16, np.uint16, np.int16, torch.int16),
             "float8_e4m3fn": (torch.float8_e4m3fn, np.uint8, np.uint8,
                               torch.uint8),
             "float8_e5m2": (torch.float8_e5m2, np.uint8, np.uint8,
                             torch.uint8)}
_TORCH_LOGICAL = {v[0]: name for name, v in _RAW_VIEW.items()}

_log = logging.getLogger(__name__)


class CheckpointCorruptError(RuntimeError):
    """A committed step failed integrity verification (crc/manifest/leaf)."""


def _leaf_file(path) -> str:
    return "__".join(str(p) for p in path) + ".npy"


def pack_ragged(lists) -> Dict[str, np.ndarray]:
    """A list of int lists as two checkpointable arrays (values + offsets);
    the selectors' fitted communities serialize through this."""
    flat = np.asarray([v for sub in lists for v in sub], np.int64)
    offsets = np.cumsum([0] + [len(sub) for sub in lists]).astype(np.int64)
    return {"flat": flat, "offsets": offsets}


def unpack_ragged(tree: Dict[str, np.ndarray]) -> List[List[int]]:
    flat = np.asarray(tree["flat"])
    offs = np.asarray(tree["offsets"])
    return [[int(v) for v in flat[offs[i]:offs[i + 1]]]
            for i in range(len(offs) - 1)]


def _json_safe(obj):
    """Metadata as plain JSON types: numpy scalars and arrays (virtual
    clocks, round counters) become Python numbers and lists."""
    if isinstance(obj, dict):
        return {str(k): _json_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_json_safe(v) for v in obj]
    if isinstance(obj, np.bool_):
        return bool(obj)
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    return obj


def _raw_array(leaf) -> Tuple[np.ndarray, str]:
    """(the array as written to disk, its logical dtype)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        name = _TORCH_LOGICAL.get(t.dtype)
        if name is not None:
            _, raw, _, int_t = _RAW_VIEW[name]
            return t.view(int_t).numpy().view(raw), name
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _host_copy(leaf):
    """A host copy that shares no memory with ``leaf``."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return np.array(leaf, copy=True)


def _write(ckpt_dir: str, step: int, items: Sequence[Tuple[tuple, Any]],
           metadata: Dict) -> str:
    step_dir = os.path.join(ckpt_dir, f"step_{step}")
    tmp_dir = step_dir + ".tmp"
    if os.path.exists(tmp_dir):
        shutil.rmtree(tmp_dir)
    os.makedirs(tmp_dir, exist_ok=True)
    manifest = {"step": step, "leaves": [], "metadata": metadata}
    for path, leaf in items:
        arr, logical = _raw_array(leaf)
        fname = _leaf_file(path)
        np.save(os.path.join(tmp_dir, fname), arr)
        crc = zlib.crc32(np.ascontiguousarray(arr).tobytes())
        manifest["leaves"].append({"path": list(path), "file": fname,
                                   "shape": list(arr.shape),
                                   "dtype": logical, "crc32": int(crc)})
    with open(os.path.join(tmp_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(step_dir):
        shutil.rmtree(step_dir)
    os.rename(tmp_dir, step_dir)
    commit = step_dir + ".COMMIT"
    with open(commit, "w") as f:
        f.write("ok")
    return commit


def save_checkpoint(ckpt_dir: str, step: int, tree: Any, *,
                    metadata: Optional[Dict] = None) -> str:
    """Atomic synchronous save. Returns the commit marker path."""
    return _write(ckpt_dir, step, tree_paths(tree), _json_safe(metadata or {}))


def _committed_steps(ckpt_dir: str) -> List[int]:
    """Step numbers with a COMMIT marker (no integrity check)."""
    if not os.path.isdir(ckpt_dir):
        return []
    steps = []
    for name in os.listdir(ckpt_dir):
        if name.endswith(".COMMIT"):
            try:
                steps.append(int(name[len("step_"):-len(".COMMIT")]))
            except ValueError:
                continue
    return steps


def _step_intact(ckpt_dir: str, step: int) -> bool:
    """Manifest readable and every leaf file present; the crcs are checked
    at load."""
    step_dir = os.path.join(ckpt_dir, f"step_{step}")
    try:
        with open(os.path.join(step_dir, "manifest.json")) as f:
            manifest = json.load(f)
        return all(os.path.isfile(os.path.join(step_dir, e["file"]))
                   for e in manifest["leaves"])
    except (OSError, ValueError, KeyError, TypeError):
        return False


def latest_step(ckpt_dir: str) -> Optional[int]:
    """Newest committed step whose directory is intact; a torn one is
    skipped with a warning."""
    for step in sorted(_committed_steps(ckpt_dir), reverse=True):
        if _step_intact(ckpt_dir, step):
            return step
        _log.warning("checkpoint step_%d is committed but torn; skipping",
                     step)
    return None


def _load_step(ckpt_dir: str, step: int, device=None) -> Dict:
    """One committed step, each leaf's crc32 verified where recorded.
    Raises ``CheckpointCorruptError`` on a mismatch, ``OSError`` /
    ``ValueError`` on missing or unreadable files."""
    step_dir = os.path.join(ckpt_dir, f"step_{step}")
    with open(os.path.join(step_dir, "manifest.json")) as f:
        manifest = json.load(f)
    tree: Dict = {}
    for entry in manifest["leaves"]:
        arr = np.load(os.path.join(step_dir, entry["file"]))
        want = entry.get("crc32")
        if want is not None:
            got = zlib.crc32(np.ascontiguousarray(arr).tobytes())
            if got != int(want):
                raise CheckpointCorruptError(
                    f"step_{step}/{entry['file']}: crc32 mismatch "
                    f"(manifest {int(want)}, file {got})")
        leaf: Any = arr
        if entry["dtype"] in _RAW_VIEW:
            dtype, _, int_np, _ = _RAW_VIEW[entry["dtype"]]
            leaf = torch.from_numpy(arr.view(int_np)).view(dtype)
        if device is not None:
            leaf = torch.as_tensor(leaf).to(device)
        path = tuple(entry["path"])
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return {"tree": tree, "step": step, "metadata": manifest["metadata"]}


def restore_checkpoint(ckpt_dir: str, step: Optional[int] = None, *,
                       device=None, shardings: Any = None) -> Dict:
    """Returns {"tree": nested dict, "step": int, "metadata": dict}.

    ``device`` puts every leaf on that device as a tensor. With
    ``step=None`` committed steps are tried newest first, and one that
    fails verification (torn dir, unreadable manifest, crc32 mismatch) is
    skipped with a warning; an explicit ``step`` raises on any failure."""
    if shardings is not None:
        raise TypeError("restore onto shardings is not ported (ROADMAP "
                        "A14); pass device=")
    if step is not None:
        return _load_step(ckpt_dir, step, device)
    for s in sorted(_committed_steps(ckpt_dir), reverse=True):
        try:
            return _load_step(ckpt_dir, s, device)
        except (OSError, ValueError, KeyError, CheckpointCorruptError) as e:
            _log.warning("checkpoint step_%d unusable (%s); falling back to "
                         "the previous committed step", s, e)
    raise FileNotFoundError(f"no usable committed checkpoint in {ckpt_dir}")


class CheckpointManager:
    """Retention, async saves and resume."""

    def __init__(self, ckpt_dir: str, *, keep: int = 3,
                 async_save: bool = True):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        os.makedirs(ckpt_dir, exist_ok=True)

    def save(self, step: int, tree: Any, metadata: Optional[Dict] = None):
        # snapshot to the host before the thread starts: training goes on
        # updating the live tensors, some of them in place
        items = [(path, _host_copy(leaf)) for path, leaf in tree_paths(tree)]
        meta = _json_safe(metadata or {})

        def work():
            try:
                _write(self.ckpt_dir, step, items, meta)
                self._gc()
            except BaseException as e:  # surfaced on wait()/next save()
                self._error = e

        if self.async_save:
            self.wait()  # re-raises a previous background failure
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()
        else:
            _write(self.ckpt_dir, step, items, meta)
            self._gc()

    def wait(self):
        """Block until the in-flight save lands; re-raise its failure, so a
        failed write never passes for a committed step."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("async checkpoint save failed") from err

    def restore(self, step: Optional[int] = None, *, device=None,
                shardings=None) -> Dict:
        self.wait()
        return restore_checkpoint(self.ckpt_dir, step, device=device,
                                  shardings=shardings)

    def _gc(self):
        for s in sorted(self._committed())[:-self.keep]:
            shutil.rmtree(os.path.join(self.ckpt_dir, f"step_{s}"),
                          ignore_errors=True)
            try:
                os.remove(os.path.join(self.ckpt_dir, f"step_{s}.COMMIT"))
            except FileNotFoundError:
                pass

    def _committed(self) -> List[int]:
        return _committed_steps(self.ckpt_dir)
