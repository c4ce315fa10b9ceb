"""Granite 3.0 2B [hf:ibm-granite/granite-3.0-2b-base; hf] — dense GQA."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite_3_2b", family="dense",
    n_layers=40, d_model=2048, n_heads=32, n_kv_heads=8, head_dim=64,
    d_ff=8192, vocab_size=49155, rope_theta=1e4,
    pattern=(("attn", "mlp"),),
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=257, q_chunk=32, kv_chunk=32,
)
