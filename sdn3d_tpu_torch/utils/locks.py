"""Frame lock files for concurrent / resumable batch runs.

Parity with geometric/scripts/main.py:707-716: a `.lock` marker lets
re-runs (or several concurrent workers) skip frames that are done or in
flight; a crash-guard context skips frames whose processing raises
(:798-810's bare except/continue)."""

from __future__ import annotations

import contextlib
import os


def try_claim(image_dir: str, name: str) -> bool:
    """Atomically claim a frame; False if already claimed/processed."""
    os.makedirs(image_dir, exist_ok=True)
    lock = os.path.join(image_dir, f"{name}.lock")
    try:
        fd = os.open(lock, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        os.close(fd)
        return True
    except FileExistsError:
        return False


@contextlib.contextmanager
def crash_guard(name: str):
    """Skip-on-exception guard around per-frame work (main.py:798-810)."""
    try:
        yield
    except Exception as exc:          # noqa: BLE001 — parity with reference
        print(f"WARNING: frame {name} failed and was skipped: {exc!r}")
