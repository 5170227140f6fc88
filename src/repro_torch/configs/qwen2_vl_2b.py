"""qwen2-vl-2b [vlm] — M-RoPE, dynamic resolution (vision tower stubbed)
[arXiv:2409.12191].

The reference's config, copied: the published
widths at full depth, its parallelism plan, and the smoke-test cut."""
from repro_torch.configs.base import ModelConfig, ParallelPlan

CONFIG = ModelConfig(
    name="qwen2-vl-2b",
    family="vlm",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    d_ff=8960,
    vocab_size=151936,
    qkv_bias=True,
    rope_type="mrope",
    mrope_sections=(16, 24, 24),   # sum = head_dim/2 = 64
    rope_theta=1e6,
)

PLAN = ParallelPlan(fsdp=False, tp=True, sp=False, ep=False,
                    grad_accum=2, optimizer="adamw", param_dtype="float32")

SMOKE = CONFIG.scaled(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                      d_ff=128, vocab_size=256, head_dim=16,
                      mrope_sections=(4, 2, 2))
