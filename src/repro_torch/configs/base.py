"""Configuration dataclasses: model architecture, training, parallelism
(counterpart of ``repro/configs/base.py``, field for field).

Every assigned architecture is a ``ModelConfig`` instance in its own module
under ``repro_torch.configs``; reduced smoke variants derive from the full config
via ``smoke()``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 0
    top_k: int = 0
    every: int = 1              # every k-th block is MoE (1 = all)
    shared_expert: bool = False  # llama4-style always-on shared expert
    dispatch: str = "dense"      # "dense" | "sort" | "multisplit"
    capacity_factor: float = 1.25
    router_z_loss: float = 1e-3
    aux_loss: float = 1e-2


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state: int = 0              # d_state (zamba2: 64)
    conv: int = 4               # conv1d width
    headdim: int = 64
    expand: int = 2
    attn_every: int = 0         # hybrid: a (shared) attention block every k blocks
    shared_attn: bool = False   # zamba2: ONE attention block's params reused


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int

    head_dim: Optional[int] = None
    norm: str = "rmsnorm"       # rmsnorm | layernorm
    rope_theta: float = 1e4
    rope_pct: float = 1.0       # stablelm-2 uses partial rotary (25%)
    window: Optional[int] = None  # sliding-window attention (h2o-danube)
    tie_embeddings: bool = False
    logit_softcap: float = 0.0

    moe: MoEConfig = MoEConfig()
    ssm: SSMConfig = SSMConfig()

    # xLSTM: every k-th block is sLSTM, the rest mLSTM (0 = no lstm blocks)
    slstm_every: int = 0
    # VLM: every k-th block gets cross-attention to vision embeddings
    cross_attn_every: int = 0
    n_vis_tokens: int = 0
    # audio: input is precomputed frame embeddings (frontend stubbed)
    embed_frontend_stub: bool = False

    dtype: str = "bfloat16"
    remat: bool = True
    scan_blocks: bool = True
    attn_chunk: int = 1024      # KV block size for chunked (flash-style) attention
    loss_chunk: int = 512       # sequence block size for chunked cross-entropy
    ssd_chunk: int = 256        # SSD / mLSTM chunk length
    # Dry-run cost accounting: XLA cost_analysis counts while-loop bodies
    # once, so the roofline lowering unrolls every inner scan (see
    # launch/dryrun.py two-point delta method).
    unroll_scans: bool = False
    # perf lever (§Perf): attention probabilities cast to bf16 for the
    # p@V matmul (softmax stats stay fp32)
    attn_probs_bf16: bool = False
    # perf lever (§Perf): pad the vocab dim of embedding/head to a multiple
    # of 2048 so it shards over TP even for awkward vocabs (minicpm: 122753)
    pad_vocab: bool = False
    # perf lever (§Perf): zero-pad attention heads to a multiple of TP at
    # runtime when the head count doesn't divide (minicpm: 36 over 16) —
    # 1.33x head compute vs 16x replicated attention memory
    pad_attn_heads: bool = False
    # perf lever (§Perf): keep logits in bf16; cross-entropy accumulates the
    # logsumexp in fp32 without materializing fp32 logits
    loss_bf16_logits: bool = False

    def padded_vocab(self) -> int:
        if not self.pad_vocab:
            return self.vocab
        return -(-self.vocab // 2048) * 2048

    def hd(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    def is_subquadratic(self) -> bool:
        """May run the long_500k shape (SSM / hybrid / sliding-window)."""
        return self.family in ("ssm", "hybrid") or self.window is not None

    def smoke(self) -> "ModelConfig":
        """Reduced same-family config for CPU smoke tests."""
        scale = {
            "d_model": 64,
            "n_heads": 4,
            "n_kv": min(self.n_kv, 4) if self.n_kv < self.n_heads else 4,
            "d_ff": 128 if self.d_ff else 0,
            "vocab": 512,
            "head_dim": 16,
            "n_vis_tokens": 16 if self.n_vis_tokens else 0,
            "window": 64 if self.window else None,
            "attn_chunk": 64,
            "loss_chunk": 64,
            "dtype": "float32",
        }
        # keep the structural pattern but only a couple of super-blocks
        pat = _pattern_period(self)
        scale["n_layers"] = 2 * pat
        moe = self.moe
        if moe.num_experts:
            # high capacity factor: smoke tests check decode == forward, which
            # requires no capacity drops
            moe = dataclasses.replace(
                moe, num_experts=8, top_k=min(moe.top_k, 2), capacity_factor=4.0
            )
        ssm = self.ssm
        if ssm.state:
            ssm = dataclasses.replace(ssm, state=16, headdim=16, expand=2)
        return dataclasses.replace(self, name=self.name + "-smoke", moe=moe, ssm=ssm, **scale)


def _pattern_period(cfg: ModelConfig) -> int:
    """Length of one structural super-block (see models/model.py)."""
    if cfg.family == "hybrid" and cfg.ssm.attn_every:
        return cfg.ssm.attn_every
    if cfg.family == "vlm" and cfg.cross_attn_every:
        return cfg.cross_attn_every
    if cfg.family == "moe" and cfg.moe.every > 1:
        return cfg.moe.every
    if cfg.slstm_every:
        return cfg.slstm_every
    return 1


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    global_batch: int = 256
    seq_len: int = 4096
    lr: float = 3e-4
    schedule: str = "cosine"    # cosine | wsd (minicpm's Warmup-Stable-Decay)
    warmup_steps: int = 100
    decay_start: float = 0.8    # WSD: fraction of total steps where decay begins
    total_steps: int = 10000
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    clip_norm: float = 1.0
    moments_dtype: str = "float32"  # float32 | bfloat16 (memory-bound archs)
    # "bfloat16": train-state params are bf16 (halved weight reads + bf16
    # gradient reductions); the fp32 master copy lives in the optimizer state
    params_dtype: str = "float32"
    accum_steps: int = 1
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    fsdp: bool = False           # shard params/opt-state over the data axis
    seq_shard_prefill: bool = False  # sequence parallelism for long prefill
    grad_compress: bool = False  # int8 + error-feedback cross-pod gradients
    dp_axes: Tuple[str, ...] = ("data",)
    tp_axis: str = "model"
