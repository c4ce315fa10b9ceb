"""Architecture config schema + registry.

Each assigned architecture gets one module in this package defining
``CONFIG`` (the exact published config) and ``SMOKE`` (a reduced config of
the same family for CPU smoke tests).  ``get_config(name, smoke=False)``
resolves either.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Tuple

Sublayer = Tuple[str, str | None]  # (mixer, ffn) kinds


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int                   # total decoder sublayers
    d_model: int
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0
    vocab_size: int = 0
    qkv_bias: bool = False
    window: int = 0                 # sliding-window size; 0 = full attention
    rope_theta: float = 1e4
    use_rope: bool = True
    # repeating sublayer pattern; n_layers must be len(pattern) * n_blocks
    pattern: Tuple[Sublayer, ...] = (("attn", "mlp"),)
    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    # SSM (Mamba-2 / SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_groups: int = 1
    ssm_conv: int = 4
    # encoder (enc-dec archs); encoder uses bidirectional attention
    enc_layers: int = 0
    # modality frontends (STUBS: input_specs provides embeddings directly)
    vision_prefix: int = 0          # of patch-embedding positions
    audio_stride: int = 0           # encoder frames = seq_len // stride
    # numerics
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    norm_eps: float = 1e-5
    # runtime knobs (hillclimb levers)
    q_chunk: int = 1024
    kv_chunk: int = 1024
    remat: str = "dots"             # none | dots | full
    scan_layers: bool = True
    xent_chunk: int = 512           # tokens per chunked-xent scan step
    accum_steps: int = 0            # 0 = use the shape table's default
    moe_impl: str = "bucket"        # bucket (capacity GEMM) | ragged
    fsdp_weights: bool = True       # False: inference plan (no ZeRO gather)
    moe_barrier: bool = False       # pin MoE boundary dtype (qwen3 perf)
    embed_impl: str = "gather"      # gather | psum (shard_map mask+psum;
                                    # tried in llama §Perf iter 3: refuted)
    # collective schedule for the Gleam-adapted layer
    collective_schedule: str = "xla"   # xla | gleam_tree | ring | unicast

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def n_blocks(self) -> int:
        assert self.n_layers % len(self.pattern) == 0, (
            f"{self.name}: n_layers={self.n_layers} not a multiple of "
            f"pattern length {len(self.pattern)}")
        return self.n_layers // len(self.pattern)

    @property
    def is_subquadratic(self) -> bool:
        """True if long_500k is runnable: SSM/hybrid or sliding-window."""
        kinds = {m for m, _ in self.pattern}
        return ("mamba" in kinds) or (self.window > 0)

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)


ARCH_IDS = (
    "mixtral_8x7b",
    "qwen3_moe_235b_a22b",
    "granite_3_2b",
    "llama3_2_3b",
    "h2o_danube_3_4b",
    "qwen1_5_110b",
    "whisper_medium",
    "mamba2_370m",
    "internvl2_26b",
    "jamba_v0_1_52b",
)


def get_config(name: str, smoke: bool = False) -> ArchConfig:
    key = name.replace("-", "_").replace(".", "_")
    if key not in ARCH_IDS:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{key}")
    return mod.SMOKE if smoke else mod.CONFIG
