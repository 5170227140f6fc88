"""Peak rates of the card the port targets: one NVIDIA H100 SXM, from
NVIDIA's data sheet (dense rates, at the full 700 W power limit).

The least time a piece of work can take on the card is the larger of its
bytes over ``HBM_BYTES_PER_S`` and its operations over the peak rate of
their type. ``chip_smoke.py`` prices every kernel's bound with these, and
the tuner's analytic cost model (``tune/seed.py``) scores candidates with
the same numbers, so the two never disagree about the card. The dry run's
roofline (``roofline/analysis.py``) takes its rates from here too, with the
memory size and the link rate below.
"""
from __future__ import annotations

#: device memory rate (HBM3), bytes a second
HBM_BYTES_PER_S = 3.35e12
#: fp32 rate outside the tensor cores, flops a second
FP32_FLOPS = 67e12
#: dense bf16 rate of the tensor cores, flops a second
BF16_TC_FLOPS = 989e12
#: dense TF32 rate of the tensor cores, flops a second
TF32_TC_FLOPS = 495e12
#: the card's memory, bytes: ``torch.cuda.get_device_properties(0).
#: total_memory`` on an NVIDIA H100 80GB HBM3 at a 700.00 W power limit
#: (``nvidia-smi``); ``chip_smoke.py``'s dryrun phase holds it equal
HBM_BYTES = 85_017_493_504
#: one collective link, bytes a second each way: a 400 Gb/s NDR
#: InfiniBand port a GPU (DGX H100: eight a node of eight GPUs). A 16-wide
#: mesh axis spans nodes, so the dry run prices every collective here
LINK_BYTES_PER_S = 50e9
#: NVLink 4 inside a node, bytes a second each way (18 links × 25 GB/s);
#: recorded, unused: the roofline keeps the reference's single link rate
NVLINK_BYTES_PER_S = 450e9
