"""dbrx-132b [moe] — 16 experts top-4, fine-grained
[hf:databricks/dbrx-base].

The reference's config, copied: the published
widths at full depth, its parallelism plan, and the smoke-test cut."""
from repro_torch.configs.base import ModelConfig, ParallelPlan

CONFIG = ModelConfig(
    name="dbrx-132b",
    family="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=10752,
    vocab_size=100352,
    n_experts=16,
    n_experts_active=4,
    moe_d_ff=10752,
    rope_theta=5e5,
)

PLAN = ParallelPlan(fsdp=True, tp=True, sp=True, ep=True,
                    grad_accum=8, optimizer="adafactor", param_dtype="bfloat16")

SMOKE = CONFIG.scaled(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                      d_ff=128, moe_d_ff=128, vocab_size=256,
                      n_experts=4, n_experts_active=2)
