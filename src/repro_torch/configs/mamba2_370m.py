"""Mamba2-370m [arXiv:2405.21060; unverified] — attention-free SSD.
d_inner = 2*1024 = 2048, headdim 64 -> 32 SSD heads, d_state 128."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2_370m", family="ssm",
    n_layers=48, d_model=1024, vocab_size=50280,
    pattern=(("mamba", None),),
    ssm_state=128, ssm_expand=2, ssm_headdim=64, ssm_groups=1, ssm_conv=4,
    remat="full",           # fit HBM: dots policy saves gathered weights
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, vocab_size=256, ssm_state=16, ssm_headdim=16,
    q_chunk=32, kv_chunk=32,
)
