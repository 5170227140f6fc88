"""llama3-405b [dense] — GQA, 128k vocab [arXiv:2407.21783].

The reference's config, copied: the published
widths at full depth, its parallelism plan, and the smoke-test cut."""
from repro_torch.configs.base import ModelConfig, ParallelPlan

CONFIG = ModelConfig(
    name="llama3-405b",
    family="dense",
    n_layers=126,
    d_model=16384,
    n_heads=128,
    n_kv_heads=8,
    d_ff=53248,
    vocab_size=128256,
    rope_theta=5e5,
)

PLAN = ParallelPlan(fsdp=True, tp=True, sp=True, ep=False,
                    grad_accum=16, optimizer="adafactor", param_dtype="bfloat16")

SMOKE = CONFIG.scaled(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                      d_ff=256, vocab_size=256)
