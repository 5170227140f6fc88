"""zamba2-2.7b [hybrid] — Mamba2 backbone + shared attention blocks
[arXiv:2411.15242].

The reference's config, copied: the published
widths at full depth, its parallelism plan, and the smoke-test cut."""
from repro_torch.configs.base import ModelConfig, ParallelPlan

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    head_dim=80,
    d_ff=10240,                 # shared block MLP
    vocab_size=32000,
    ssm_state=64,
    ssm_conv=4,
    ssm_expand=2,
    ssm_head_dim=64,
    attn_every=6,               # shared attn+MLP block after every 6 mamba layers
    mlp_act="gelu",
)

PLAN = ParallelPlan(fsdp=False, tp=True, sp=False, ep=False,
                    grad_accum=2, optimizer="adamw", param_dtype="float32")

SMOKE = CONFIG.scaled(n_layers=4, d_model=64, n_heads=2, n_kv_heads=2,
                      head_dim=32, d_ff=128, vocab_size=256, ssm_state=16,
                      ssm_head_dim=16, attn_every=2)
