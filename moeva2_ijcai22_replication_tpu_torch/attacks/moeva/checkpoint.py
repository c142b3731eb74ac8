"""Mid-attack checkpoints of MoEvA2 (port of ``attacks/moeva/checkpoint.py``).

Every ``checkpoint_every`` generations the engine writes its evolution
state to one ``.npz``: the carry's tensors (populations, objectives,
archive, normalisation memory) as numpy arrays and the state of the run's
random stream (``core.philox.PhiloxStream.get_state()``: its key and next
counter), so that a rerun of the same attack resumes mid-run and continues the same
stream, bit-identical to an uninterrupted run. Early-exit runs add host
state that the carry cannot express, the active-set mapping and the
solved states' parked results, as ``extra`` arrays in the same file; a
history sidecar directory keeps one ``.npy`` per recorded history segment
(``add_hist_chunk``).

The file is written atomically (a temporary file, then ``os.replace``) and
carries a fingerprint of the attack (inputs and every knob that changes
the result, ``Moeva2._fingerprint``): a file with another fingerprint, or
one that cannot be read, is ignored and the run starts afresh. A file of
this attack written before the engine drew from the Philox stream (its
random state a ``torch.Generator``'s) is refused with
:class:`StaleStreamCheckpoint`: resumed, it would continue on another
stream. A run that completes removes its files (``clear``).
"""

from __future__ import annotations

import json
import os
import shutil
import zipfile

import numpy as np
import torch

from ...core.philox import STREAM

_META = "__meta__"
#: what reading a truncated, corrupt or foreign file raises
_UNREADABLE = (OSError, ValueError, KeyError, EOFError, zipfile.BadZipFile)


class StaleStreamCheckpoint(RuntimeError):
    """A checkpoint of this attack whose random state is not the Philox
    stream's."""


class AttackCheckpointer:
    """Save and restore the engine's evolution state under a fingerprint."""

    def __init__(self, path: str, fingerprint: str):
        self.path = path
        self.fingerprint = fingerprint
        self.hist_dir = path + ".hist"
        #: the ``extra`` arrays of the last successful :meth:`load`, or None
        self.extra: dict | None = None

    def save(self, leaves, done: int, n_hist: int, extra: dict | None = None) -> None:
        """Write ``leaves`` (tensors on any device), the generation steps
        ``done`` and the number of history sidecars ``n_hist`` that the
        snapshot counts, with the host arrays of ``extra``."""
        arrays = [t.detach().cpu().numpy() for t in leaves]
        meta = json.dumps({
            "fingerprint": self.fingerprint,
            "done": int(done),
            "n_leaves": len(arrays),
            "n_hist": int(n_hist),
            "extra_keys": sorted(extra) if extra else [],
            "stream": STREAM,
        })
        tmp = self.path + ".tmp"
        with open(tmp, "wb") as fh:
            np.savez(
                fh,
                **{f"leaf_{i}": a for i, a in enumerate(arrays)},
                **{f"extra_{k}": np.asarray(v) for k, v in (extra or {}).items()},
                **{_META: np.asarray(meta)},
            )
        os.replace(tmp, self.path)

    def load(self, template):
        """``(leaves, done, hist_chunks)`` restored from the file, or None
        when there is none, its fingerprint differs, or it (or a sidecar)
        cannot be read; raises :class:`StaleStreamCheckpoint` for a file of
        this attack written before the Philox stream. Each leaf takes the dtype and device of its entry
        of ``template`` (a fresh carry's tensors); its shape is the file's,
        which a repacked run has shrunk."""
        self.extra = None
        if not os.path.exists(self.path):
            return None
        try:
            with np.load(self.path, allow_pickle=False) as z:
                meta = json.loads(str(z[_META]))
                if meta.get("fingerprint") != self.fingerprint:
                    return None
                if meta.get("stream") != STREAM:
                    raise StaleStreamCheckpoint(
                        f"{self.path} holds this attack's state with a torch.Generator's random state, written "
                        f"before the engine drew from the counter-based Philox stream ({STREAM}); it cannot resume on the "
                        "new stream: remove it to run the attack afresh"
                    )
                arrays = [z[f"leaf_{i}"] for i in range(meta["n_leaves"])]
                keys = meta.get("extra_keys") or []
                extra = {k: z[f"extra_{k}"] for k in keys} if keys else None
        except _UNREADABLE:
            return None  # a truncated or corrupt file: start afresh
        if len(arrays) != len(template):
            return None
        for a, t in zip(arrays, template):
            if a.ndim != t.dim() or a.shape[1:] != tuple(t.shape[1:]) or torch.from_numpy(a).dtype != t.dtype:
                return None
        hist = []
        for i in range(meta["n_hist"]):
            try:
                hist.append(np.load(self._hist_file(i)))
            except _UNREADABLE:
                return None  # a missing or truncated sidecar: start afresh
        self.extra = extra
        leaves = [torch.as_tensor(a).to(device=t.device, dtype=t.dtype) for a, t in zip(arrays, template)]
        return leaves, int(meta["done"]), hist

    def _hist_file(self, idx: int) -> str:
        return os.path.join(self.hist_dir, f"chunk_{idx:05d}.npy")

    def add_hist_chunk(self, idx: int, arr: np.ndarray) -> None:
        """Write history segment ``idx`` atomically to its sidecar."""
        os.makedirs(self.hist_dir, exist_ok=True)
        tmp = os.path.join(self.hist_dir, ".tmp.npy")
        np.save(tmp, arr)
        os.replace(tmp, self._hist_file(idx))

    def clear(self) -> None:
        """Remove the files of a completed run."""
        for p in (self.path, self.path + ".tmp"):
            if os.path.exists(p):
                os.remove(p)
        if os.path.isdir(self.hist_dir):
            shutil.rmtree(self.hist_dir)
