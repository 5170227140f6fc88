"""The port's rule catalog — one ``default_rules()`` so the CLI, the chip
check and the tests all lint with the same set (DESIGN.md §12)."""
from __future__ import annotations

from typing import List, Optional

from repro_torch.analysis.engine import Rule
from repro_torch.analysis.rules_delta import DeltaLedgerRule
from repro_torch.analysis.rules_fence import EpochFenceRule
from repro_torch.analysis.rules_hopper import HopperBudgetRule
from repro_torch.analysis.rules_hostsync import HostSyncRule
from repro_torch.analysis.rules_metrics import MetricsConformanceRule
from repro_torch.analysis.rules_recompile import Pow2WidthRule


def default_rules(ptxas_logs: Optional[dict] = None, root: str = ".",
                  launches: Optional[list] = None) -> List[Rule]:
    """Every rule; ``ptxas_logs`` ({source stem: ``ptxas -v`` text}) and
    ``launches`` (the card's records of the kernels' launches,
    ``rules_hopper.parse_trace``) feed the Hopper rule, which has nothing
    to price without the logs and reads the kernel sources under ``root``
    (the repository's)."""
    return [
        DeltaLedgerRule(),
        EpochFenceRule(),
        HostSyncRule(),
        Pow2WidthRule(),
        MetricsConformanceRule(),
        HopperBudgetRule(ptxas_logs or {}, root=root, launches=launches),
    ]
