"""Whisper-medium [arXiv:2212.04356; unverified] — enc-dec, conv frontend STUB.

The audio frontend is a stub: input_specs() provides precomputed frame
embeddings of length seq_len // audio_stride (DESIGN.md §8). Encoder is
bidirectional; decoder is causal + cross-attention. MHA (kv == heads)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper_medium", family="encdec",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16, head_dim=64,
    d_ff=4096, vocab_size=51865, qkv_bias=True, use_rope=False,
    pattern=(("attn", "mlp"),),
    enc_layers=24, audio_stride=4,
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=256, enc_layers=2, q_chunk=32, kv_chunk=32,
)
