"""Model configuration of the port (the fields of the JAX package's
``repro.models.config.ModelConfig`` that the port runs).

A model is a repeating ``pattern`` of blocks applied ``n_groups`` times plus
an optional ``tail``, for every block kind of the JAX package: ``"attn"``
(attention + MLP), ``"moe"`` (attention + mixture-of-experts FFN),
``"mamba"`` (Mamba2 / SSD), ``"shared_attn"`` (attention + MLP whose
weights every occurrence shares) and ``"cross"`` (self-attention +
cross-attention + MLP: the decoder layers of the encoder-decoder family and
the image layers of the VLM family).  The attention blocks run on the
``taylor``, ``softmax``, ``softmax_window`` and ``linear_elu`` backends,
uniform or per pattern position (``attention_schedule``: hybrid models such
as the Based-style taylor + ``softmax_window`` interleave).  Families:
``"lm"`` (decoder-only), ``"encdec"`` (an ``encoder_pattern`` stack over
stubbed audio frames, whisper-style) and ``"vlm"`` (a projector over stubbed
vision-tower embeddings).  A stack of mamba blocks may carry Zamba2's hybrid
sites (``SiteConfig``): shared attention blocks over the stream and the
embeddings, each site with its own adapter and linear, in training only.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from repro_torch.core.feature_map import TaylorConfig

BLOCK_KINDS = ("attn", "moe", "mamba", "shared_attn", "cross")
FAMILIES = ("lm", "encdec", "vlm")
ACTS = ("silu", "gelu", "geglu", "geglu_erf")
NORMS = ("rmsnorm", "layernorm")
POSITIONS = ("rope", "learned", "sinusoidal", "none")
ATTN_IMPLS = ("auto", "torch", "cuda")
ATTN_SHARDINGS = ("tp", "cp")
REMATS = ("none", "full", "dots_saveable")


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared_experts: int = 0
    d_ff_shared: int = 0           # total shared-expert hidden size
    capacity_factor: float = 1.25  # for the capacity ("ep") dispatch path
    router_noise: float = 0.0      # carried, read by no path (as in the JAX package)
    impl: str = "auto"             # "dense" | "ep" | "ep_a2a" | "auto"
    a2a_quant: str = "none"        # "none" | "int8": read by "ep_a2a" only


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    expand: int = 2
    head_dim: int = 64             # P — SSD head channel dim
    conv_width: int = 4
    n_groups: int = 1              # B/C groups (GQA analogue)

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_ssm_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclasses.dataclass(frozen=True)
class SiteConfig:
    """Zamba2's hybrid sites over a stack of mamba blocks.

    At each site a shared attention block runs before the mamba block of
    its layer.  The sites take the ``n_blocks`` shared blocks in turn (site
    j runs block ``j % n_blocks``).  A shared block reads ``cat(x, x0)``
    (``attention_width`` = 2·d_model; x0 is the embedding output) through
    an RMSNorm of that width, then attention, an RMSNorm(d_model) and a
    gated MLP whose ``gate_up`` the site's own rank-``adapter_rank`` adapter
    adds to.  It has no residual: its output passes through the site's own
    d_model × d_model ``linear`` and is added to the input of the layer's
    mamba block, before that block's norm::

        x <- x + mamba(norm(x + linear_j(shared_{j % n_blocks}(x, x0))))
    """

    layer_ids: Tuple[int, ...]
    n_blocks: int = 1
    adapter_rank: int = 0


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # "lm" | "encdec" | "vlm"
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    # depth = n_groups * len(pattern) + len(tail)
    pattern: Tuple[str, ...]
    n_groups: int
    tail: Tuple[str, ...] = ()

    head_dim: int = 0              # 0 → d_model // n_heads
    # "silu" | "geglu" (tanh GELU) | "geglu_erf" (exact GELU), gated without
    # biases; "gelu": the plain 2-matrix MLP with biases (tanh GELU)
    act: str = "silu"
    norm: str = "rmsnorm"          # "rmsnorm" | "layernorm"
    norm_eps: float = 1e-6
    qkv_bias: bool = False
    tie_embeddings: bool = False
    pos: str = "rope"              # "rope" | "learned" | "sinusoidal" | "none"
    rope_theta: float = 10000.0
    embed_scale: bool = False      # gemma-style sqrt(d_model) embedding scale
    logit_softcap: float = 0.0

    # --- attention backend ---
    attention: str = "softmax"     # resolved through repro_torch.backends
    taylor: TaylorConfig = TaylorConfig()
    attn_chunk: int = 128          # chunk of the taylor chunked scan
    # Execution engine within the backend (mirrors the JAX package's
    # "auto" | "xla" | "pallas"):
    #   "auto"  — the CUDA kernel on a CUDA device inside its envelope,
    #             else the plain PyTorch paths
    #   "torch" — force the plain PyTorch paths (the reference)
    #   "cuda"  — force the CUDA kernel; configs outside its envelope raise
    attn_impl: str = "auto"
    # "tp": shard heads over the model axis (megatron-style).
    # "cp": context parallelism — shard the SEQUENCE over the model axis and
    #       exchange only the O(d²·d_v) moment state (taylor backend only;
    #       the state-sum property is unique to linear attention).
    attn_sharding: str = "tp"
    # --- per-layer attention schedule (hybrid models) ---
    # Maps pattern positions (indices into ``pattern``; the pattern repeats
    # in every group, so a position addresses the same layer of all
    # n_groups) to registered backend names.  Positions absent from it, and
    # the tail and the encoder, use ``attention``.  A dict is accepted at construction and
    # normalised to a sorted tuple of (position, name) pairs without the
    # entries that name the default, so two spellings of one schedule
    # compare equal and configs stay hashable.
    attention_schedule: Tuple[Tuple[int, str], ...] = ()
    # Sliding-window size (tokens) of the ``softmax_window`` backend's
    # O(window) ring-buffer KV cache.
    attn_window: int = 128

    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # Zamba2's hybrid sites (``SiteConfig``): shared blocks over the stream
    # and the embeddings before chosen mamba layers; a port-only field
    sites: Optional[SiteConfig] = None

    # --- encoder-decoder (whisper) ---
    n_encoder_groups: int = 0
    encoder_pattern: Tuple[str, ...] = ()
    n_audio_ctx: int = 0           # stubbed conv-frontend output length

    # --- vlm ---
    n_image_tokens: int = 0
    vision_dim: int = 0

    # --- numerics / training ---
    dtype: str = "bfloat16"        # activation dtype
    param_dtype: str = "float32"
    # "full": each block's activations are recomputed in the backward
    # (torch.utils.checkpoint per block); "none": all are kept;
    # "dots_saveable": the matrix products' outputs are kept too
    remat: str = "full"
    max_seq: int = 131072

    def __post_init__(self):
        self._normalise_schedule()
        for kind in self.pattern + self.tail + self.encoder_pattern:
            if kind not in BLOCK_KINDS:
                raise ValueError(f"unknown block kind {kind!r}")
        if self.family not in FAMILIES:
            raise ValueError(f"family must be one of {FAMILIES}, got {self.family!r}")
        if self.norm not in NORMS:
            raise ValueError(f"norm must be one of {NORMS}, got {self.norm!r}")
        if self.pos not in POSITIONS:
            raise ValueError(f"pos must be one of {POSITIONS}, got {self.pos!r}")
        if "moe" in self.pattern + self.tail and self.moe is None:
            raise ValueError("a 'moe' block needs ModelConfig.moe")
        if "mamba" in self.pattern + self.tail and self.ssm is None:
            raise ValueError("a 'mamba' block needs ModelConfig.ssm")
        if self.act not in ACTS:
            raise ValueError(f"act must be one of {ACTS}, got {self.act!r}")
        if self.attn_impl not in ATTN_IMPLS:
            raise ValueError(
                f"attn_impl must be auto|torch|cuda, got {self.attn_impl!r}"
            )
        if self.attn_sharding not in ATTN_SHARDINGS:
            raise ValueError(
                f"attn_sharding must be tp|cp, got {self.attn_sharding!r}"
            )
        if self.attn_window < 1:
            raise ValueError(f"attn_window must be >= 1, got {self.attn_window}")
        if self.remat not in REMATS:
            raise ValueError(f"remat must be one of {REMATS}, got {self.remat!r}")
        if self.sites is not None:
            self._check_sites()

    def _check_sites(self) -> None:
        s = self.sites
        if set(self.pattern + self.tail) != {"mamba"} or self.family != "lm":
            raise ValueError("hybrid sites sit in a decoder-only stack of mamba blocks")
        ids = tuple(s.layer_ids)
        if not ids or list(ids) != sorted(set(ids)) or not 0 <= ids[0] <= ids[-1] < self.n_layers:
            raise ValueError(f"site layer ids must be increasing and below {self.n_layers}, "
                             f"got {ids}")
        if s.n_blocks < 1 or s.adapter_rank < 0:
            raise ValueError(f"a site config needs n_blocks >= 1 and adapter_rank >= 0, got {s}")
        if self.act not in ("silu", "geglu", "geglu_erf"):
            raise ValueError(f"a site's MLP is gated: act {self.act!r}")
        if self.n_heads * self.resolved_head_dim != self.attention_width:
            raise ValueError("a site's heads span its input: n_heads * head_dim must equal "
                             f"2 * d_model = {self.attention_width}")

    def _normalise_schedule(self) -> None:
        """Validate ``attention_schedule`` against the pattern and the
        backend registry and store its normal form (the JAX package's
        checks and messages)."""
        sched = self.attention_schedule
        if isinstance(sched, dict):
            sched = tuple(sched.items())
        norm = {}
        for pos, name in sched:
            pos = int(pos)
            if not 0 <= pos < len(self.pattern):
                raise ValueError(
                    f"attention_schedule position {pos} outside pattern "
                    f"(len {len(self.pattern)})"
                )
            if self.pattern[pos] == "mamba":
                raise ValueError(
                    f"attention_schedule position {pos} is a 'mamba' block — "
                    "only attention-bearing blocks take a backend"
                )
            if pos in norm and norm[pos] != name:
                raise ValueError(
                    f"attention_schedule position {pos} mapped twice "
                    f"({norm[pos]!r} and {name!r})"
                )
            norm[pos] = name
        if norm:
            from repro_torch.backends.registry import get_backend  # noqa: PLC0415 (cycle)

            for pos, name in norm.items():
                backend = get_backend(name)  # raises on unknown names
                if backend.level != "qkv":
                    raise ValueError(
                        f"attention_schedule position {pos}: backend {name!r} "
                        f"is {backend.level}-level, not a qkv attention backend"
                    )
                if self.pattern[pos] == "cross" and not backend.supports_cross:
                    raise ValueError(
                        f"attention_schedule position {pos} is a 'cross' "
                        f"block but backend {name!r} has supports_cross=False"
                    )
        object.__setattr__(
            self,
            "attention_schedule",
            tuple(sorted((p, n) for p, n in norm.items() if n != self.attention)),
        )

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def attention_width(self) -> int:
        """The width attention projects from: ``cat(x, x0)`` at hybrid sites,
        the stream otherwise."""
        return 2 * self.d_model if self.sites is not None else self.d_model

    @property
    def site_of_layer(self) -> dict:
        """{layer index: site index} of the hybrid sites ({} without)."""
        return {i: j for j, i in enumerate(self.sites.layer_ids)} if self.sites else {}

    @property
    def n_layers(self) -> int:
        return self.n_groups * len(self.pattern) + len(self.tail)

    @property
    def n_encoder_layers(self) -> int:
        return self.n_encoder_groups * len(self.encoder_pattern)

    @property
    def n_source_tokens(self) -> int:
        """Length of the cross-attention source: the image tokens (vlm), the
        audio frames (encdec), 0 for a decoder-only model."""
        return {"vlm": self.n_image_tokens, "encdec": self.n_audio_ctx}.get(self.family, 0)

    @property
    def is_attention_free(self) -> bool:
        """True when every block is a mamba block (no attention layer)."""
        return set(self.pattern) | set(self.tail) <= {"mamba"}

    @property
    def pattern_backends(self) -> Tuple[str, ...]:
        """Backend name per pattern position: the scheduled name, else
        ``attention`` (mamba positions too, where it is never read)."""
        sched = dict(self.attention_schedule)
        return tuple(sched.get(i, self.attention) for i in range(len(self.pattern)))

    def layer_cfg(self, backend: str) -> "ModelConfig":
        """Config view for one layer run: ``attention`` replaced by that run's
        backend, schedule cleared.  Everything below the model layer (the
        attention block, the backends, the kernels) receives this uniform
        view.  ``self`` when already uniform on ``backend``."""
        if backend == self.attention and not self.attention_schedule:
            return self
        return dataclasses.replace(self, attention=backend, attention_schedule=())

    @property
    def attention_backend_names(self) -> Tuple[str, ...]:
        """Sorted unique backend names of the attention layers: the
        pattern's positions that are not mamba blocks and, with a tail or an
        encoder that holds an attention block, the default."""
        names = {b for b, kind in zip(self.pattern_backends, self.pattern) if kind != "mamba"}
        if any(kind != "mamba" for kind in self.tail + self.encoder_pattern):
            names.add(self.attention)
        return tuple(sorted(names))

    @property
    def backend_desc(self) -> str:
        """The uniform backend name, or the "+"-joined per-layer set under a
        schedule (for error strings and labels)."""
        return "+".join(self.attention_backend_names or (self.attention,))

    @property
    def uses_kv_cache(self) -> bool:
        """True if any layer's backend keeps a KV cache (full or a ring)."""
        if self.is_attention_free:
            return False
        from repro_torch.backends.registry import get_backend  # noqa: PLC0415 (cycle)

        return any(get_backend(n).state_kind == "kv" for n in self.attention_backend_names)

    @property
    def supports_long_context(self) -> bool:
        """True if every layer's decode state is bounded in context length
        (moments, an SSM state, or an O(window) ring): no layer keeps an
        O(n) KV cache."""
        if self.is_attention_free:
            return True
        from repro_torch.backends.registry import get_backend  # noqa: PLC0415 (cycle)

        return all(get_backend(n).bounded_state for n in self.attention_backend_names)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


def schedule_runs(cfg: ModelConfig) -> Tuple[Tuple[str, str, int], ...]:
    """The decoder ``pattern`` as runs of equal (kind, backend):
    ``((kind, backend_name, run_len), ...)``.

    These are the JAX package's scan runs: its stacked params ``r{j}`` and
    the per-run decode caches follow them.  With an empty schedule they are
    the runs of equal kinds alone."""
    out = []
    for kind, bk in zip(cfg.pattern, cfg.pattern_backends):
        if out and out[-1][0] == kind and out[-1][1] == bk:
            out[-1] = (kind, bk, out[-1][2] + 1)
        else:
            out.append((kind, bk, 1))
    return tuple(out)


def _mlp_params(cfg: ModelConfig, d_ff: int) -> int:
    """Params of one MLP of hidden ``d_ff``: gated (silu, geglu) 3 matrices,
    gelu 2 matrices with their biases."""
    d = cfg.d_model
    if cfg.act == "gelu":
        return 2 * d * d_ff + d_ff + d
    return 3 * d * d_ff


def _norm_params(cfg: ModelConfig) -> int:
    """Params of one norm: a scale, and a bias for layernorm."""
    return cfg.d_model * (2 if cfg.norm == "layernorm" else 1)


def _attn_params(cfg: ModelConfig, width: Optional[int] = None) -> int:
    """Params of one attention's projections (wq, wk, wv from ``width``
    (default d_model), wo back to d_model, and the qkv biases)."""
    d, h, hk, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    w = width or d
    n = w * h * hd + 2 * w * hk * hd + h * hd * d
    if cfg.qkv_bias:
        n += h * hd + 2 * hk * hd
    return n


def _mamba_params(cfg: ModelConfig) -> int:
    """Params of one mamba block: norm1 and ``ssm.mamba_init``'s leaves."""
    s, d = cfg.ssm, cfg.d_model
    di, nh = s.d_inner(d), s.n_ssm_heads(d)
    conv_ch = di + 2 * s.n_groups * s.d_state        # x, B, C
    n = _norm_params(cfg)                            # norm1
    n += d * (di + conv_ch + nh)                     # in_proj: z, x, B, C, dt
    n += s.conv_width * conv_ch + conv_ch            # conv_w, conv_b
    n += 3 * nh                                      # A_log, D, dt_bias
    return n + di * d + di                           # out_proj, gate_norm


def _block_params(cfg: ModelConfig, kind: str) -> int:
    if kind == "mamba":
        return _mamba_params(cfg)
    d = cfg.d_model
    n = 2 * _norm_params(cfg) + _attn_params(cfg)    # norm1, norm2, attn
    if kind in ("attn", "shared_attn"):
        return n + _mlp_params(cfg, cfg.d_ff)
    if kind == "cross":                              # norm_c, cross
        return n + _norm_params(cfg) + _attn_params(cfg) + _mlp_params(cfg, cfg.d_ff)
    m = cfg.moe                                      # "moe"
    n += d * m.n_experts + m.n_experts * _mlp_params(cfg, m.d_ff_expert)
    if m.n_shared_experts:
        n += _mlp_params(cfg, m.d_ff_shared)
    return n


def _site_params(cfg: ModelConfig) -> Tuple[int, int]:
    """(params of one shared block of the hybrid sites, params a site holds
    of its own: the adapter and the linear)."""
    d, w, r = cfg.d_model, cfg.attention_width, cfg.sites.adapter_rank
    block = w + _attn_params(cfg, w) + d + _mlp_params(cfg, cfg.d_ff)
    return block, d * r + r * 2 * cfg.d_ff + d * d


def count_params(cfg: ModelConfig) -> int:
    """Exact parameter count of ``lm_init(cfg)``, from the shapes alone (the
    JAX package's ``count_params``, which traces its ``lm_init``).  The
    shared block's weights are counted once, however often it occurs; the
    encoder (encdec), the vision projector (vlm) and learned position tables
    are counted with the rest; so is each of the hybrid sites' shared blocks,
    once, and each site's own adapter and linear."""
    d = cfg.d_model
    own = lambda kinds: sum(_block_params(cfg, k) for k in kinds if k != "shared_attn")
    shared = _block_params(cfg, "shared_attn") if "shared_attn" in cfg.pattern + cfg.tail else 0
    if cfg.sites is not None:
        block, own_site = _site_params(cfg)
        shared = cfg.sites.n_blocks * block + len(cfg.sites.layer_ids) * own_site
    embed = cfg.vocab * d * (1 if cfg.tie_embeddings else 2)
    n = embed + _norm_params(cfg) + cfg.n_groups * own(cfg.pattern) + own(cfg.tail) + shared
    if cfg.pos == "learned":
        n += cfg.max_seq * d
    if cfg.family == "vlm":
        n += cfg.vision_dim * d
    if cfg.family == "encdec":
        n += cfg.n_encoder_groups * own(cfg.encoder_pattern) + _norm_params(cfg)
        if cfg.pos == "learned":
            n += cfg.n_audio_ctx * d
    return n


def count_active_params(cfg: ModelConfig) -> int:
    """Active params per token (MoE: top_k routed experts + shared ones).

    The JAX package's formula: the full count less the inactive routed
    experts' matrices (``mult · d · d_ff_expert`` each, mult 3 gated or 2;
    their gelu biases stay counted); embeddings included."""
    full = count_params(cfg)
    if cfg.moe is None:
        return full
    m = cfg.moe
    mult = 2 if cfg.act == "gelu" else 3
    n_moe_blocks = cfg.pattern.count("moe") * cfg.n_groups + cfg.tail.count("moe")
    return full - n_moe_blocks * (m.n_experts - m.top_k) * mult * cfg.d_model * m.d_ff_expert
