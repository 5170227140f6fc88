"""whisper-base [audio] — enc-dec, conv frontend stubbed [arXiv:2212.04356].

The reference's config, copied: the published
widths at full depth, its parallelism plan, and the smoke-test cut."""
from repro_torch.configs.base import ModelConfig, ParallelPlan

CONFIG = ModelConfig(
    name="whisper-base",
    family="audio",
    n_layers=12,                 # 6 enc + 6 dec
    enc_layers=6,
    dec_layers=6,
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    d_ff=2048,
    vocab_size=51865,
    mlp_act="gelu",
    rope_type="none",
    tie_embeddings=True,
    dec_seq_div=8,
)

PLAN = ParallelPlan(fsdp=False, tp=False, sp=False, ep=False,
                    grad_accum=1, optimizer="adamw", param_dtype="float32")

SMOKE = CONFIG.scaled(enc_layers=2, dec_layers=2, n_layers=4, d_model=64,
                      n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=256)
