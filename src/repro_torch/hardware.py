"""Peak rates of the card the port targets: one NVIDIA H100 SXM, from
NVIDIA's data sheet (dense rates, at the full 700 W power limit).

The least time a piece of work can take on the card is the larger of its
bytes over ``HBM_BYTES_PER_S`` and its operations over the peak rate of
their type. ``chip_smoke.py`` prices every kernel's bound with these, and
the tuner's analytic cost model (``tune/seed.py``) scores candidates with
the same numbers, so the two never disagree about the card.
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
