from repro_torch.roofline.analysis import (HW, Hardware, RooflineTerms,
                                           analyze_counts,
                                           model_flops_estimate)
from repro_torch.roofline.count import CountMode, Counts

__all__ = ["CountMode", "Counts", "HW", "Hardware", "RooflineTerms",
           "analyze_counts", "model_flops_estimate"]
