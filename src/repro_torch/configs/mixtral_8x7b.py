"""Mixtral 8x7B [arXiv:2401.04088; hf] — 8-expert top-2 MoE, GQA kv=8, SWA."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mixtral_8x7b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=32000, window=4096, rope_theta=1e6,
    pattern=(("attn", "moe"),),
    n_experts=8, top_k=2, moe_d_ff=14336,
    remat="full",           # fit HBM: dots policy saves gathered weights
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, moe_d_ff=128, vocab_size=256, n_experts=4, top_k=2,
    window=32, q_chunk=32, kv_chunk=32,
)
