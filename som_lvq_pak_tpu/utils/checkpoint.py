"""Training-state checkpoints for the fast (minibatch/sharded) path.

The reference's recovery story is file-based: codebooks are plain text
files and olvq1 persists per-code learning rates to a `.lra` sidecar so
training can continue (datafile.c:1030-1086, lvq_rout.c:614-627); the
interval snapshot subsystem writes intermediate codebooks
(lvq_pak.c:663-867).  The framework's equivalent checkpoints the full train
state — codebook array, per-code alphas, step counter, RNG state —
atomically, with optional background writes, so a multi-host run can
restart from the latest step (SURVEY.md §5).

Format: one directory per run holding `step_<N>.npz` files (atomic
rename from a temp file) plus the step metadata inside the archive.
"""

from __future__ import annotations

import json
import os
import re
import tempfile
import threading
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np

_STEP_RE = re.compile(r"^step_(\d+)\.npz$")


@dataclass
class TrainState:
    codes: np.ndarray                      # (noc, D) float32 codebook
    step: int = 0
    alphas: Optional[np.ndarray] = None    # per-code learning rates (olvq1)
    rng_state: Optional[int] = None        # CRandom LCG state
    prng_key: Optional[np.ndarray] = None  # jax.random key data (fast path)
    extra: Dict[str, Any] = field(default_factory=dict)


class Checkpointer:
    """Save/restore TrainState under a run directory.

    `keep`: retain at most this many newest checkpoints (0 = all).
    `background`: write on a worker thread (the fork-style async
    snapshot, lvq_pak.c:690-720, without the process boundary — arrays
    are copied before the thread starts so training can mutate on)."""

    def __init__(self, directory: str, keep: int = 3, background: bool = False):
        self.directory = directory
        self.keep = keep
        self.background = background
        self._thread: Optional[threading.Thread] = None
        self._thread_exc: Optional[BaseException] = None
        os.makedirs(directory, exist_ok=True)

    # -- write ----------------------------------------------------------

    def save(self, state: TrainState) -> str:
        path = os.path.join(self.directory, f"step_{state.step}.npz")
        payload = {
            "codes": np.asarray(state.codes),
            "step": np.int64(state.step),
        }
        if state.alphas is not None:
            payload["alphas"] = np.asarray(state.alphas)
        if state.rng_state is not None:
            payload["rng_state"] = np.uint64(state.rng_state)
        if state.prng_key is not None:
            payload["prng_key"] = np.asarray(state.prng_key)
        if state.extra:
            payload["extra_json"] = np.frombuffer(
                json.dumps(state.extra).encode(), dtype=np.uint8
            )
        # copy before handing to the writer so the trainer can mutate on
        payload = {k: np.array(v, copy=True) for k, v in payload.items()}

        if self.background:
            self.wait()

            def writer():
                try:
                    self._write(path, payload)
                except BaseException as e:  # surfaced by the next wait()
                    self._thread_exc = e

            self._thread = threading.Thread(target=writer, daemon=True)
            self._thread.start()
        else:
            self._write(path, payload)
        return path

    def _write(self, path: str, payload: Dict[str, np.ndarray]) -> None:
        fd, tmp = tempfile.mkstemp(dir=self.directory, suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                np.savez(f, **payload)
            os.replace(tmp, path)  # atomic publish
        except BaseException:
            if os.path.exists(tmp):
                os.remove(tmp)
            raise
        self._gc()

    def wait(self) -> None:
        """Join any pending background write (waitpid analogue); a write
        failure on the worker thread re-raises here so a disk-full
        checkpoint is never silently 'saved'."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._thread_exc is not None:
            exc = self._thread_exc
            self._thread_exc = None
            raise exc

    def _gc(self) -> None:
        if self.keep <= 0:
            return
        for step in self.steps()[: -self.keep]:
            os.remove(os.path.join(self.directory, f"step_{step}.npz"))

    # -- read -----------------------------------------------------------

    def steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.directory):
            m = _STEP_RE.match(name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def load(self, step: Optional[int] = None) -> Optional[TrainState]:
        """Load the given (default: latest) checkpoint; None if empty."""
        if step is None:
            step = self.latest_step()
            if step is None:
                return None
        with np.load(os.path.join(self.directory, f"step_{step}.npz")) as z:
            extra = {}
            if "extra_json" in z:
                extra = json.loads(bytes(z["extra_json"].tobytes()).decode())
            return TrainState(
                codes=z["codes"],
                step=int(z["step"]),
                alphas=z["alphas"] if "alphas" in z else None,
                rng_state=int(z["rng_state"]) if "rng_state" in z else None,
                prng_key=z["prng_key"] if "prng_key" in z else None,
                extra=extra,
            )

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.wait()
        return False
