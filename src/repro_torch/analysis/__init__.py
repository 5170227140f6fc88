"""repro_torch.analysis — the invariant lint engine over the port, the
counterpart of ``repro/analysis`` (DESIGN.md §12).

The same AST rule engine (``engine.py``: inline ``# repro-lint:
allow[rule]`` suppressions, the ratchet baseline, line-free
fingerprints), its own copy, with the rules retargeted at
``src/repro_torch``: the δ ledger through ``core/confidence.py``, the
epoch fence in ``api/handle.py``, host syncs (``.item()``, ``.cpu()``,
``.tolist()``, ``.numpy()``) on the per-epoch hot paths outside
``utils/hostsync.host_fetch``, the metrics naming of ``obs/registry.py``,
pow2 widths in the frontier, plane and session files, and the Hopper
counterpart of ``rules_pallas.py``: each CUDA kernel's registers, shared
memory and spills from ``ptxas -v`` against the H100's budgets
(``rules_hopper.py``). The port's baseline is
``tools/torch_lint_baseline.json``; its CLI ``tools/torch_lint.py``.

Pure stdlib on purpose, as the reference's: the linter imports neither
torch nor the reference.
"""
from repro_torch.analysis.catalog import default_rules
from repro_torch.analysis.engine import (BASELINE_VERSION, REPORT_VERSION,
                                         Finding, LintEngine, LintReport,
                                         Rule, apply_baseline, baseline_from,
                                         load_baseline, save_baseline)

__all__ = [
    "BASELINE_VERSION", "REPORT_VERSION", "Finding", "LintEngine",
    "LintReport", "Rule", "apply_baseline", "baseline_from",
    "default_rules", "load_baseline", "save_baseline",
]
