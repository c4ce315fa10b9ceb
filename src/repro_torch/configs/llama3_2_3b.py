"""Llama-3.2 3B [hf:meta-llama/Llama-3.2-1B; unverified] — dense GQA, 24 heads
(NOT divisible by the 16-way model axis: exercises the head_dim sharding
fallback in the planner)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama3_2_3b", family="dense",
    n_layers=28, d_model=3072, n_heads=24, n_kv_heads=8, head_dim=128,
    d_ff=8192, vocab_size=128256, rope_theta=5e5,
    pattern=(("attn", "mlp"),),
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=48, n_heads=3, n_kv_heads=1, head_dim=16,
    d_ff=128, vocab_size=256, q_chunk=32, kv_chunk=32,
)
