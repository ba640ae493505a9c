"""Dataset-generation epoch key.

Counterpart of `pde_control_tpu/utils/epoch.py`, sharing its `.vm_epoch`
file at the repo root. Rollouts are chaotic, so regenerated datasets differ
across machine wipes (rounding amplified over the trajectory): absolute
MSEs from different wipe generations are not comparable, only
controlled / zero-force ratios are. The epoch is a random token in the
git-ignored `.vm_epoch` file, minted on first use and destroyed by the
same wipe that removes the datasets; every results.json is stamped with it.
Falls back to a hash of the machine id if the repo root is unwritable.
"""

from __future__ import annotations

import errno
import hashlib
import os
import uuid

_EPOCH_FILE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".vm_epoch")


def _machine_id_epoch() -> str:
    for path in ("/etc/machine-id", "/proc/sys/kernel/random/boot_id"):
        try:
            with open(path) as f:
                raw = f.read().strip()
            if raw:
                return hashlib.sha256(raw.encode()).hexdigest()[:12]
        except OSError:
            continue
    return "unknown"


def vm_epoch(path: str = _EPOCH_FILE) -> str:
    """Short identifier of the current dataset/wipe generation.

    Reads the gitignored epoch file, minting it atomically when the last
    wipe destroyed it: the token is fully written to a temp file, then
    os.link()ed into place — link is atomic AND refuses to clobber an
    existing path (EEXIST), so a concurrent reader either sees no file or
    a COMPLETE token, never the empty window between O_CREAT and the
    content write that could make two same-generation processes stamp
    different epochs. Losers of the link race re-read the
    winner's token."""
    def _read() -> str | None:
        try:
            with open(path) as f:
                v = f.read().strip()
            return v or None
        except OSError:
            return None

    v = _read()
    if v:
        return v
    token = uuid.uuid4().hex[:12]
    # uuid-keyed tmp (not pid): a stale tmp from a crashed process + PID
    # reuse would otherwise EEXIST here and spuriously take the
    # machine-id fallback while the epoch file still doesn't exist.
    tmp = f"{path}.tmp.{token}"
    try:
        fd = os.open(tmp, os.O_WRONLY | os.O_CREAT | os.O_EXCL, 0o644)
        with os.fdopen(fd, "w") as f:
            f.write(token)
        try:
            os.link(tmp, path)  # atomic publish; EEXIST = lost the race
        except OSError as e:
            if e.errno != errno.EEXIST:
                raise
        finally:
            os.unlink(tmp)
        return _read() or _machine_id_epoch()
    except OSError:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        # Repo root unwritable: fall back to the machine-id hash.
        return _read() or _machine_id_epoch()


def stamp(results: dict) -> dict:
    """Add the epoch key to a results dict (in place; returns it)."""
    results.setdefault("vm_epoch", vm_epoch())
    return results


def check_same_epoch(paths_epochs) -> list[str]:
    """Given (name, epoch) pairs, return the names whose epoch differs
    from the current VM's — the rows whose absolute MSEs must not be
    compared against freshly measured ones."""
    cur = vm_epoch()
    return [name for name, ep in paths_epochs if ep and ep != cur]
