"""xlstm-350m [ssm] — sLSTM + mLSTM blocks [arXiv:2405.04517].

The reference's config, copied: the published
widths at full depth, its parallelism plan, and the smoke-test cut."""
from repro_torch.configs.base import ModelConfig, ParallelPlan

CONFIG = ModelConfig(
    name="xlstm-350m",
    family="ssm",
    n_layers=24,
    d_model=1024,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,                      # no separate FFN; projections live in-block
    vocab_size=50304,
    ssm_conv=4,
    slstm_every=4,               # every 4th block is sLSTM (6 of 24)
    rope_type="none",
)

PLAN = ParallelPlan(fsdp=False, tp=True, sp=False, ep=False,
                    grad_accum=4, optimizer="adamw", param_dtype="float32")

# reduced config for CPU smoke tests
SMOKE = CONFIG.scaled(n_layers=4, d_model=64, n_heads=2, n_kv_heads=2,
                      vocab_size=256, slstm_every=2)
