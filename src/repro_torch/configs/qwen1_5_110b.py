"""Qwen1.5 110B [hf:Qwen/Qwen1.5-0.5B; hf] — dense GQA with QKV bias (largest dense)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen1_5_110b", family="dense",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=49152, vocab_size=152064, qkv_bias=True, rope_theta=1e6,
    pattern=(("attn", "mlp"),),
    remat="full", accum_steps=16,  # 82.9GB temp at accum=8 + dots
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=256, q_chunk=32, kv_chunk=32,
)
