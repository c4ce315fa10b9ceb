"""Jamba v0.1 52B [arXiv:2403.19887; hf] — Mamba+attn 1:7 interleave, MoE 16e top-2.

Period-8 superblock: attention at position 3, Mamba elsewhere; MoE FFN at
odd positions (every other layer), dense MLP at even. 32 layers = 4 blocks.
Attention layers are full-attention, but the hybrid is sub-quadratic overall
(4 attention layers; KV for long_500k sharded over the data axis)."""
from repro_torch.configs.base import ArchConfig

_PATTERN = tuple(
    ("attn" if i == 3 else "mamba", "moe" if i % 2 == 1 else "mlp")
    for i in range(8)
)

CONFIG = ArchConfig(
    name="jamba_v0_1_52b", family="hybrid",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=65536, use_rope=False,
    pattern=_PATTERN,
    n_experts=16, top_k=2, moe_d_ff=14336,
    ssm_state=16, ssm_expand=2, ssm_headdim=64, ssm_groups=1, ssm_conv=4,
    remat="full",           # fit HBM: dots policy saves gathered weights
)

SMOKE = CONFIG.replace(
    n_layers=8, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, moe_d_ff=128, vocab_size=256, n_experts=4, top_k=2,
    ssm_state=16, ssm_headdim=16, q_chunk=32, kv_chunk=32,
)
