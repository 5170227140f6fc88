"""qwen2.5-14b [dense] — GQA with QKV bias [hf:Qwen/Qwen2.5]. The reference's
config, copied: the published widths at full depth, its parallelism plan,
and the smoke-test cut."""
from repro_torch.configs.base import ModelConfig, ParallelPlan

CONFIG = ModelConfig(
    name="qwen2.5-14b",
    family="dense",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=13824,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1e6,
)

PLAN = ParallelPlan(fsdp=True, tp=True, sp=True, ep=False,
                    grad_accum=8, optimizer="adamw", param_dtype="float32")

SMOKE = CONFIG.scaled(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                      d_ff=128, vocab_size=256)
