"""Fleet manifest: one versioned JSON file at the fleet root
(DESIGN.md §11.3), the reference's ``fleet.json``.

The manifest records every namespace's shard count, device offset,
admission override, live-row count and store kind: enough for
``Fleet.open(root)`` to rebuild the routing table without materializing an
index. The namespace directories (``<root>/ns/<name>/``) hold the
checkpoints, payloads and tuned sidecars. Either package opens the other's
fleet root: the file, its keys and the namespace directories are the same.

Writes are atomic (tmp + ``os.replace``), so a crash mid-update leaves the
previous manifest readable. The fallback is strict: a missing, unreadable,
malformed or version-bumped manifest reads as "no fleet here".
"""
from __future__ import annotations

import json
import logging
import os
from typing import Optional

log = logging.getLogger("repro_torch.fleet")

FLEET_FILE = "fleet.json"
FLEET_VERSION = 1


def save_manifest(root: str, namespaces: dict) -> str:
    """Atomically publish the fleet manifest under ``root``.
    ``namespaces``: name → record (``shards``, ``device_offset``,
    ``max_queue``, ``n_live``, ``kind``). Returns the file's path."""
    doc = {"version": FLEET_VERSION, "namespaces": namespaces}
    fpath = os.path.join(root, FLEET_FILE)
    tmp = fpath + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=2, sort_keys=True)
    os.replace(tmp, fpath)
    return fpath


def load_manifest(root: str) -> Optional[dict]:
    """``root``'s manifest, validated; None when there is no valid fleet
    there."""
    fpath = os.path.join(root, FLEET_FILE)
    if not os.path.exists(fpath):
        return None
    try:
        with open(fpath) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        log.warning("unreadable fleet manifest at %s", fpath)
        return None
    if not isinstance(doc, dict) or doc.get("version") != FLEET_VERSION:
        log.warning("fleet manifest version %r != %d at %s",
                    doc.get("version") if isinstance(doc, dict) else None,
                    FLEET_VERSION, fpath)
        return None
    if not isinstance(doc.get("namespaces"), dict):
        log.warning("malformed fleet manifest at %s", fpath)
        return None
    return doc
