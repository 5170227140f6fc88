"""granite-34b [dense] — llama-arch MQA code model [arXiv:2405.04324].

The reference's config, copied: the published
widths at full depth, its parallelism plan, and the smoke-test cut."""
from repro_torch.configs.base import ModelConfig, ParallelPlan

CONFIG = ModelConfig(
    name="granite-34b",
    family="dense",
    n_layers=88,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,               # MQA
    d_ff=24576,
    vocab_size=49152,
)

PLAN = ParallelPlan(fsdp=True, tp=True, sp=True, ep=False,
                    grad_accum=16, optimizer="adamw", param_dtype="float32")

SMOKE = CONFIG.scaled(n_layers=2, d_model=64, n_heads=4, n_kv_heads=1,
                      d_ff=128, vocab_size=256)
