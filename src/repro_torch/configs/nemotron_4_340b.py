"""nemotron-4-340b [dense] — GQA, squared-ReLU MLP [arXiv:2402.16819].

The reference's config, copied: the published
widths at full depth, its parallelism plan, and the smoke-test cut."""
from repro_torch.configs.base import ModelConfig, ParallelPlan

CONFIG = ModelConfig(
    name="nemotron-4-340b",
    family="dense",
    n_layers=96,
    d_model=18432,
    n_heads=96,
    n_kv_heads=8,
    d_ff=73728,
    vocab_size=256000,
    mlp_act="sq_relu",
)

PLAN = ParallelPlan(fsdp=True, tp=True, sp=True, ep=False,
                    grad_accum=16, optimizer="adafactor", param_dtype="bfloat16")

SMOKE = CONFIG.scaled(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                      d_ff=256, vocab_size=256)
