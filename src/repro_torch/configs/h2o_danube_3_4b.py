"""H2O-Danube3 4B [arXiv:2401.16818; unverified] — llama+mistral mix, SWA.
head_dim = 3840/32 = 120 (non-128-aligned: kernel path pads, XLA path exact)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="h2o_danube_3_4b", family="dense",
    n_layers=24, d_model=3840, n_heads=32, n_kv_heads=8, head_dim=120,
    d_ff=10240, vocab_size=32000, window=4096, rope_theta=1e4,
    pattern=(("attn", "mlp"),),
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=256, window=32, q_chunk=32, kv_chunk=32,
)
