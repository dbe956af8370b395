"""Fault-tolerant checkpointing: atomic writes, keep-N, auto-resume,
integrity verification.

- Checkpoints are written atomically (tmp dir + rename), so a failure
  mid-save never corrupts the latest checkpoint.
- Every array carries a crc32 checksum in the manifest; restore detects
  truncated or bit-flipped checkpoints and ``restore_latest`` falls back
  to the previous keep-N checkpoint instead of loading garbage.
- A checkpoint is a tree (``repro_torch.tree``: nested dicts, tuples and
  NamedTuples) of tensors, numpy arrays and Python scalars.  ``save``
  copies every leaf to host numpy before the background writer starts
  (``async_save=True``), so training may go on changing the tensors;
  ``close()`` joins the writer.  ``restore`` puts each leaf back on the
  device and dtype of the matching leaf of ``like``.
- ``latest_step()`` and ``restore_latest()`` skip and garbage-collect
  orphaned ``.tmp_*`` dirs left by a process killed mid-save; keep_n
  bounds disk usage.

The array-dir helpers (``publish_array_dir`` / ``load_array_dir``) write
the same npz + manifest format as the reference's.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading
import warnings
import zipfile
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.tree import tree_flatten_with_names, tree_unflatten

Tree = Any

TMP_PREFIX = ".tmp_"


class CheckpointCorruptError(Exception):
    """A checkpoint failed integrity verification (truncated npz,
    checksum mismatch, missing arrays, unreadable manifest)."""


def _crc32(arr: np.ndarray) -> int:
    a = np.ascontiguousarray(arr)
    return zlib.crc32(a.tobytes()) & 0xFFFFFFFF


def publish_array_dir(
    directory: str,
    name: str,
    arrays: Dict[str, np.ndarray],
    manifest: Dict,
) -> str:
    """Atomically write `arrays` + `manifest` as `directory/name`.

    Writes arrays.npz and manifest.json (augmented with per-array crc32
    checksums) into a `.tmp_*` dir, then publishes with a single rename
    — a crash at any point leaves either the previous version or an
    orphaned tmp dir, never a half-written published dir.
    """
    final = os.path.join(directory, name)
    os.makedirs(directory, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=directory, prefix=TMP_PREFIX)
    try:
        np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
        doc = dict(manifest)
        doc["checksums"] = {k: _crc32(v) for k, v in arrays.items()}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(doc, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic publish
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return final


def load_array_dir(path: str) -> Tuple[Dict[str, np.ndarray], Dict]:
    """Load and checksum-verify an array dir written by
    `publish_array_dir`. Raises CheckpointCorruptError on any integrity
    failure; manifests without checksums (older checkpoints) load
    unverified for backward compatibility."""
    manifest_path = os.path.join(path, "manifest.json")
    try:
        with open(manifest_path) as f:
            manifest = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        raise CheckpointCorruptError(
            f"unreadable manifest in {path}: {e}"
        ) from e
    try:
        with np.load(os.path.join(path, "arrays.npz")) as data:
            arrays = {k: data[k] for k in data.files}
    except (OSError, ValueError, zlib.error, EOFError,
            zipfile.BadZipFile) as e:
        raise CheckpointCorruptError(
            f"unreadable/truncated arrays.npz in {path}: {e}"
        ) from e
    checksums = manifest.get("checksums")
    if checksums is not None:
        missing = set(checksums) - set(arrays)
        if missing:
            raise CheckpointCorruptError(
                f"arrays missing from {path}: {sorted(missing)}"
            )
        for k, want in checksums.items():
            got = _crc32(arrays[k])
            if got != want:
                raise CheckpointCorruptError(
                    f"checksum mismatch for '{k}' in {path}: "
                    f"manifest {want:#010x} != data {got:#010x}"
                )
    return arrays, manifest


def gc_orphan_tmpdirs(directory: str) -> List[str]:
    """Remove orphaned `.tmp_*` dirs left by a process killed mid-save.
    Returns the paths removed. Caller must ensure no save is in flight
    in this process (CheckpointManager guards this itself)."""
    removed = []
    if not os.path.isdir(directory):
        return removed
    for d in os.listdir(directory):
        if d.startswith(TMP_PREFIX):
            p = os.path.join(directory, d)
            shutil.rmtree(p, ignore_errors=True)
            removed.append(p)
    return removed


def _to_host(leaf) -> np.ndarray:
    """A copy of ``leaf`` as a host numpy array."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy().copy()
    return np.array(leaf)


def _like(arr: np.ndarray, like):
    """``arr`` as the type, dtype and device of the leaf ``like``."""
    if isinstance(like, torch.Tensor):
        return torch.from_numpy(np.array(arr)).to(  # np.array keeps 0-d
            device=like.device, dtype=like.dtype
        )
    if isinstance(like, np.ndarray):
        return np.asarray(arr).astype(like.dtype)
    if isinstance(like, (bool, int, float)):
        return type(like)(arr)
    return arr


class CheckpointManager:
    def __init__(
        self,
        directory: str,
        keep_n: int = 3,
        async_save: bool = False,
    ):
        self.directory = directory
        self.keep_n = keep_n
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self.fallbacks = 0  # corrupt checkpoints skipped by restore_latest
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------- lifecycle
    def close(self):
        """Join any in-flight async save. After close() the manager is
        still usable; this only drains the writer so interpreter exit
        cannot strand a partial `.tmp_*` dir."""
        self.wait()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # ------------------------------------------------------------ save
    def save(self, step: int, tree: Tree, metadata: Optional[Dict] = None):
        """Atomic checkpoint of a tree at `step`."""
        names, leaves = tree_flatten_with_names(tree)
        host_leaves = [_to_host(x) for x in leaves]
        if self.async_save:
            self.wait()  # at most one in-flight save
            self._thread = threading.Thread(
                target=self._write, args=(step, names, host_leaves, metadata)
            )
            self._thread.start()
        else:
            self._write(step, names, host_leaves, metadata)

    def _write(self, step, names, host_leaves, metadata):
        publish_array_dir(
            self.directory,
            f"step_{step:010d}",
            {f"a{i}": x for i, x in enumerate(host_leaves)},
            {"step": step, "names": names, "metadata": metadata or {}},
        )
        self._gc()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self):
        steps = self.all_steps()
        for s in steps[: -self.keep_n] if self.keep_n else []:
            shutil.rmtree(
                os.path.join(self.directory, f"step_{s:010d}"),
                ignore_errors=True,
            )

    def _gc_orphans(self):
        # only safe when this process has no writer mid-save; another
        # manager instance's live tmp dir would be renamed away before
        # we could race it in the workflows this repo runs (one writer
        # per directory).
        if self._thread is not None and self._thread.is_alive():
            return
        removed = gc_orphan_tmpdirs(self.directory)
        for p in removed:
            warnings.warn(
                f"checkpoint: removed orphaned partial save {p} "
                "(process killed mid-save?)",
                stacklevel=3,
            )

    # --------------------------------------------------------- restore
    def all_steps(self):
        out = []
        for d in os.listdir(self.directory):
            if d.startswith("step_"):
                # ignore partially-renamed/corrupt dirs without manifest
                if os.path.exists(
                    os.path.join(self.directory, d, "manifest.json")
                ):
                    out.append(int(d.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        self._gc_orphans()
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, like: Tree) -> Tree:
        """Restore into the structure of `like`, each leaf on the device
        and dtype of its counterpart there. Raises CheckpointCorruptError
        if the checkpoint fails checksum/read verification, ValueError on
        a structure mismatch."""
        path = os.path.join(self.directory, f"step_{step:010d}")
        data, manifest = load_array_dir(path)
        names, like_leaves = tree_flatten_with_names(like)
        if names != manifest["names"]:
            raise ValueError(
                "checkpoint/model structure mismatch: "
                f"{set(names) ^ set(manifest['names'])}"
            )
        try:
            leaves = [data[f"a{i}"] for i in range(len(names))]
        except KeyError as e:
            raise CheckpointCorruptError(
                f"array {e} missing from {path}"
            ) from e
        return tree_unflatten(
            like, [_like(x, lk) for x, lk in zip(leaves, like_leaves)]
        )

    def restore_latest(
        self, like: Tree
    ) -> Tuple[Optional[int], Optional[Tree]]:
        """Restore the newest checkpoint that passes integrity
        verification. A corrupt checkpoint is skipped with a loud
        warning (`self.fallbacks` counts them) and the previous keep-N
        checkpoint is tried — a byte-flipped latest save degrades the
        recovery point instead of crashing the resume."""
        self._gc_orphans()
        for step in reversed(self.all_steps()):
            try:
                return step, self.restore(step, like)
            except CheckpointCorruptError as e:
                self.fallbacks += 1
                warnings.warn(
                    f"checkpoint step {step} failed integrity check "
                    f"({e}); falling back to previous checkpoint",
                    stacklevel=2,
                )
        return None, None
