"""Tuned-config persistence: the ``tuned.json`` sidecar and the
in-process cache (DESIGN.md §9.5), the reference's layout and reasons.

The sidecar rides the index checkpoint exactly like ``payload.npy``: one
versioned JSON file next to the checkpoint payload, written by
``Index.save`` when a tuned config is active and validated by
``Index.load`` against the reloaded store's signature. Fallback is strict:
a missing file, an unreadable file, a version bump, a malformed document or
a signature mismatch (the store was re-typed, moved to another device or
grew past its scale bucket since tuning) all mean "serve on build-time
defaults as if never tuned" — a stale tuning never half-applies.

The in-process cache memoizes signature → TunedConfig so repeated
``Index.tune()`` calls on equal-signature stores skip the measurement race;
``force=True`` bypasses it.
"""
from __future__ import annotations

import json
import logging
import os
from typing import Dict, Optional, Tuple

from repro_torch.tune.candidates import TUNED_VERSION, TunedConfig
from repro_torch.tune.signature import StoreSignature, signature_of

log = logging.getLogger("repro_torch.tune")

TUNED_FILE = "tuned.json"

_cache: Dict[tuple, TunedConfig] = {}


def cache_get(sig: StoreSignature) -> Optional[TunedConfig]:
    return _cache.get(sig.key())


def cache_put(sig: StoreSignature, tuned: TunedConfig) -> None:
    _cache[sig.key()] = tuned


def cache_clear() -> None:
    _cache.clear()


def save_tuned(path: str, sig: StoreSignature, tuned: TunedConfig,
               measured: Optional[dict] = None) -> str:
    """Write the sidecar into checkpoint directory ``path`` (through a
    ``.tmp`` file and ``os.replace``, so a reader never sees half of it)."""
    doc = {
        "version": TUNED_VERSION,
        "signature": sig.to_dict(),
        "config": tuned.to_dict(),
        "measured": measured or {},
    }
    fpath = os.path.join(path, TUNED_FILE)
    tmp = fpath + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=2, sort_keys=True)
    os.replace(tmp, fpath)
    return fpath


def load_tuned(path: str, store) -> Tuple[Optional[TunedConfig], str]:
    """Read + validate the sidecar for the store just loaded from ``path``.

    Returns ``(tuned, reason)`` — tuned is None unless the sidecar exists,
    parses, carries the current version, and its signature matches the
    store as reloaded; ``reason`` says why it was rejected ("ok" when
    accepted, "missing" when there is simply no sidecar, else
    "unreadable", "version", "malformed" or "signature").
    """
    fpath = os.path.join(path, TUNED_FILE)
    if not os.path.exists(fpath):
        return None, "missing"
    try:
        with open(fpath) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        log.warning("unreadable tuned sidecar at %s — serving on defaults",
                    fpath)
        return None, "unreadable"
    if not isinstance(doc, dict) or doc.get("version") != TUNED_VERSION:
        log.warning("tuned sidecar version %r != %d at %s — serving on "
                    "defaults", doc.get("version") if isinstance(doc, dict)
                    else None, TUNED_VERSION, fpath)
        return None, "version"
    try:
        sig = StoreSignature.from_dict(doc["signature"])
        tuned = TunedConfig.from_dict(doc["config"])
    except (KeyError, TypeError):
        log.warning("malformed tuned sidecar at %s — serving on defaults",
                    fpath)
        return None, "malformed"
    want = signature_of(store)
    if sig != want:
        log.warning("tuned sidecar signature drift at %s (%s -> %s) — "
                    "serving on defaults", fpath, sig.to_dict(),
                    want.to_dict())
        return None, "signature"
    return tuned, "ok"
