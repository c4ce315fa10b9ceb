"""InternVL2-26B [arXiv:2404.16821; hf] — InternViT (STUB) + InternLM2 backbone.

The vision tower is a stub: input_specs() provides vision_prefix=256
precomputed patch embeddings concatenated ahead of the text tokens."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2_26b", family="vlm",
    n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=16384, vocab_size=92553, rope_theta=1e6,
    pattern=(("attn", "mlp"),),
    vision_prefix=256,
    remat="full",           # fit HBM: dots policy saves gathered weights
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=256, vision_prefix=8, q_chunk=32, kv_chunk=32,
)
