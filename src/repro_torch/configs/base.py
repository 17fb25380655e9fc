"""Model architecture and run configuration. Input shapes (``ShapeSpec``)
come with the dry-run tooling (ROADMAP item "Tooling")."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

__all__ = ["ModelConfig", "RunConfig"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture description. One instance per assigned architecture
    (``configs/<id>.py``); ``reduced()`` derives the CPU smoke
    variant of the same family."""

    name: str
    family: str                     # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None

    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    num_shared_experts: int = 0
    capacity_factor: float = 1.25
    moe_group_size: int = 512       # GShard dispatch group length
    router_aux_coef: float = 0.01
    moe_dispatch: str = "einsum"

    # --- attention ---
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    # per-layer window pattern, repeated over depth; None entry = global attn.
    # e.g. gemma3: (1024, 1024, 1024, 1024, 1024, None)  -> 5 local : 1 global
    attn_pattern: Tuple[Optional[int], ...] = (None,)

    # --- block pattern (ssm / hybrid); entries: 'attn'|'moe'|'mlstm'|'slstm'|'hybrid'
    block_pattern: Optional[Tuple[str, ...]] = None
    ssm_state: int = 0              # mamba state dim N
    ssm_expand: int = 2             # mamba/mlstm inner expansion
    ssm_conv: int = 4               # mamba short-conv width
    ssm_chunk: int = 128            # chunkwise-scan chunk length

    # --- structure ---
    arch_type: str = "decoder"      # decoder | encdec
    encoder_layers: int = 0
    frontend: Optional[str] = None  # 'audio' | 'vision' (STUB embeddings)
    frontend_len: int = 0           # frames / patches supplied by the stub
    prefix_len: int = 0             # bidirectional prefix (VLM prefix-LM)
    tie_embeddings: bool = True
    act: str = "silu"               # mlp nonlinearity: silu (swiglu) | gelu
    norm_eps: float = 1e-6
    vocab_pad_to: int = 256
    dtype: str = "bfloat16"
    kv_cache_dtype: str = "bfloat16"

    # --- citation ---
    source: str = ""

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.block_pattern is None:
            kind = "moe" if self.num_experts else "attn"
            object.__setattr__(self, "block_pattern", (kind,))
        if self.num_heads % self.num_kv_heads:
            raise ValueError("num_heads must be divisible by num_kv_heads")

    # ---- derived ----

    @property
    def padded_vocab(self) -> int:
        p = self.vocab_pad_to
        return ((self.vocab_size + p - 1) // p) * p

    @property
    def pattern_period(self) -> int:
        return max(len(self.block_pattern), len(self.attn_pattern))

    def layer_kinds(self) -> list[str]:
        bp = self.block_pattern
        return [bp[i % len(bp)] for i in range(self.num_layers)]

    def layer_windows(self) -> list[Optional[int]]:
        ap = self.attn_pattern
        return [ap[i % len(ap)] for i in range(self.num_layers)]

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k decode: layers are SSM / windowed
        attention, allowing a MINORITY of global layers (gemma3's 5:1
        local:global long-context design — decode against a global cache is
        linear per token; the windowed majority bounds the cache growth)."""
        kinds = self.layer_kinds()
        wins = self.layer_windows()
        n_global = 0
        n_attn = 0
        for k, w in zip(kinds, wins):
            if k in ("mlstm", "slstm"):
                continue
            n_attn += 1
            if w is None:
                n_global += 1
        if n_attn == 0:
            return True
        if n_global == 0:
            return True
        return n_global / n_attn <= 0.34 and len(self.attn_pattern) > 1

    # ---- parameter counting (for 6*N*D model-FLOPs accounting) ----

    def param_count(self, active_only: bool = False) -> int:
        d, hd = self.d_model, self.head_dim
        H, KV = self.num_heads, self.num_kv_heads
        total = self.padded_vocab * d  # embed
        if not self.tie_embeddings:
            total += self.padded_vocab * d
        kinds = self.layer_kinds()

        def attn_params():
            p = d * H * hd + 2 * d * KV * hd + H * hd * d
            if self.qkv_bias:
                p += H * hd + 2 * KV * hd
            return p

        def mlp_params(f):
            return 3 * d * f if self.act in ("silu", "geglu") else 2 * d * f

        def ssm_params():
            di = self.ssm_expand * d
            if self.ssm_state:  # mamba
                return d * di * 2 + di * self.ssm_conv + di * (2 * self.ssm_state + 2) + di * d
            # mlstm: q,k,v,o over inner dim + gates
            return d * di * 4 + 2 * d * H + di * d

        for i, kind in enumerate(kinds):
            if kind == "attn":
                total += attn_params() + mlp_params(self.d_ff)
            elif kind == "moe":
                e = self.experts_per_token if active_only else self.num_experts
                total += attn_params() + (e + self.num_shared_experts) * mlp_params(self.d_ff)
                total += d * self.num_experts  # router
            elif kind == "mlstm":
                total += ssm_params()
            elif kind == "slstm":
                total += 4 * d * d + 4 * d * H  # i,f,z,o projections + gates
            elif kind == "hybrid":
                total += attn_params() + ssm_params() + mlp_params(self.d_ff)
            total += 2 * d  # norms
        if self.arch_type == "encdec":
            # encoder layers + decoder cross-attention
            enc = self.encoder_layers * (attn_params() + mlp_params(self.d_ff) + 2 * d)
            cross = self.num_layers * (attn_params() + d)
            total += enc + cross
        return int(total)

    def reduced(self) -> "ModelConfig":
        """CPU smoke variant of the same family: 2 pattern periods of layers,
        d_model <= 512, <= 4 experts."""
        period = self.pattern_period
        n_layers = min(self.num_layers, 2 * period)
        d = min(self.d_model, 256)
        hd = 32
        kv = min(self.num_kv_heads, 2)
        heads = max(kv, min(self.num_heads, 4))
        heads = (heads // kv) * kv
        enc = min(self.encoder_layers, 2)
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            num_layers=n_layers,
            d_model=d,
            num_heads=heads,
            num_kv_heads=kv,
            head_dim=hd,
            d_ff=min(self.d_ff, 512) if self.d_ff else self.d_ff,
            vocab_size=min(self.vocab_size, 1024),
            num_experts=min(self.num_experts, 4),
            experts_per_token=min(self.experts_per_token, 2),
            num_shared_experts=min(self.num_shared_experts, 1),
            moe_group_size=64,
            encoder_layers=enc,
            frontend_len=min(self.frontend_len, 16) if self.frontend_len else 0,
            prefix_len=min(self.prefix_len, 16) if self.prefix_len else 0,
            attn_pattern=tuple(
                (min(w, 64) if w is not None else None) for w in self.attn_pattern
            ),
            ssm_chunk=16,
            vocab_pad_to=64,
        )



@dataclasses.dataclass(frozen=True)
class RunConfig:
    """Training run settings: the fields of the reference's ``RunConfig``
    that the port's trainer reads, with the reference's defaults."""

    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 1000
    optimizer: str = "adamw"
    # data-parallel sync mode: 'grad_allreduce' (the plain mean over the
    # rank axis), 'param_bcast' (the paper's CA-CNTK pattern: reduce to the
    # root, then the tuned broadcast), 'tuned_allreduce' (bucketed, per-op
    # tuned allreduce plans), 'overlap_allreduce' (the same plans streamed
    # through the overlap engine: backward-order dispatch inside a tuned
    # in-flight window, the same bits) or 'compressed_allreduce' (the same
    # plans over a compressed wire with error feedback)
    sync_mode: str = "grad_allreduce"
    bcast_algo: str = "auto"
    # allreduce algorithm of the tuned/overlap/compressed modes: 'auto'
    # consults the tuner, or pin 'reduce_then_bcast' | 'fused_rsb' |
    # 'ring_allreduce' | 'xla_psum'
    allreduce_algo: str = "auto"
    # collective executor of the tuned/overlap/compressed modes: True the
    # compiled replay (fused_combine per round), False the unrolled replay,
    # None the tuned round-count policy
    compiled_collectives: Optional[bool] = None
    # in-flight bucket window of sync_mode='overlap_allreduce': None tunes
    # it (a tuner table's overlap_depth, else cost_model.optimal_overlap_depth)
    overlap_depth: Optional[int] = None
    # backward-pass seconds the overlap engine may hide collectives behind
    # (0.0: depth tuning assumes staging-bound, still streams buckets)
    overlap_compute_s: float = 0.0
    # a second comm stream for sync_mode='overlap_allreduce': right after the
    # update, the updated parameters are broadcast as the lower-priority
    # 'weight_prefetch' entry, DAG-ordered after 'grad_sync' (comm.streams).
    # Every rank holds the same parameters, so the broadcast is
    # value-identical; on the emulated mesh it broadcasts a rank-stacked
    # copy of them (4 x the parameters' bytes while it runs)
    prefetch_stream: bool = False
    # wire format of sync_mode='compressed_allreduce': 'bf16' (passthrough),
    # 'fp8' or 'int8' (1 byte per element + one f32 scale per 256)
    wire_format: str = "bf16"
    bcast_bucket_bytes: int = 4 << 20
    # a saved tuner table (Tuner.save) for the param_bcast, tuned and
    # compressed sync modes; None prices every plan analytically. An entry's
    # exec_path ('inkernel'|'compiled'|'unrolled') routes its plans
    tuner_table: Optional[str] = None
    num_microbatches: int = 1
    remat: bool = True
    seed: int = 0
