"""repro_torch.fleet — many tenant namespaces over one device set and one
request plane (DESIGN.md §11), the port of ``repro.fleet``.

``Fleet`` owns named namespaces (each a ``repro_torch.api.Index``), an LRU
residency set with evict-to-checkpoint and reload-on-touch, a shared
namespace-keyed query cache, placement by live-row footprint and a
versioned atomic manifest (``fleet.json``), so ``Fleet.open(root)`` recovers
the fleet across restarts. Serving rides one shared ``RequestPlane``
(``fleet.serve()``) with ``namespace=``-labelled tickets. A fleet root
written by either package opens in the other.
"""
from repro_torch.fleet.core import Fleet, FleetConfig
from repro_torch.fleet.manifest import (FLEET_FILE, FLEET_VERSION,
                                        load_manifest, save_manifest)
from repro_torch.fleet.placement import device_load, plan_placement

__all__ = [
    "FLEET_FILE",
    "FLEET_VERSION",
    "Fleet",
    "FleetConfig",
    "device_load",
    "load_manifest",
    "plan_placement",
    "save_manifest",
]
