"""Qwen3-MoE 235B-A22B [hf:Qwen/Qwen3-30B-A3B; hf] — 128-expert top-8 MoE, GQA kv=4."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3_moe_235b_a22b", family="moe",
    n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4, head_dim=128,
    d_ff=1536, vocab_size=151936, rope_theta=1e6,
    pattern=(("attn", "moe"),),
    n_experts=128, top_k=8, moe_d_ff=1536,
    remat="full",           # fit HBM: dots policy saves gathered weights
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=96, moe_d_ff=96, vocab_size=256, n_experts=8, top_k=2,
    q_chunk=32, kv_chunk=32,
)
