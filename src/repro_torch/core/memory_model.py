"""Stage-based memory model — the paper's Eq. (4) — for the LM zoo and the
CNN testbed, its FLOPs (Eq. 5), and the feature-cache admission ladder
(counterpart of ``repro/core/memory_model.py``; plain arithmetic).

    M_T = 2*(A(theta_T) + A(theta_op)) + P(Theta_T) + M_optimizer,T
          + max_layer_activation

A(.) is activation bytes at the stage's batch and sequence, P(.) the
resident parameter bytes (the frozen prefix still runs forward), and the
optimizer term covers only the active block and the output module. LM
parameter counts come from the LM's own params built on the meta device
(exact, nothing allocated), where the reference uses ``jax.eval_shape``;
activation bytes are a structural estimate per layer kind.

The byte counts model the simulated clients' device memory, not the card
the port runs on.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional

BYTES = {"bfloat16": 2, "float32": 4}

# Feature-cache precision tiers in admission order, each priced at its
# stored dtype (fl/quant.py stores them; int8 adds its f32 scales).
CACHE_TIERS = ("f32", "fp16", "int8")
CACHE_TIER_DTYPES = {"f32": "float32", "fp16": "float16", "int8": "int8"}
_CACHE_DTYPE_BYTES = {"float32": 4.0, "bfloat16": 2.0, "float16": 2.0,
                      "int8": 1.0}


def cache_tier_ladder(memory_bytes: float, requirement_fn,
                      tiers=CACHE_TIERS) -> Optional[str]:
    """First tier in ``tiers`` whose stage-plus-cache requirement
    (``requirement_fn(tier) -> bytes``) fits ``memory_bytes``; ``None``
    declines the cache (the client recomputes the frozen prefix)."""
    for tier in tiers:
        if memory_bytes >= requirement_fn(tier):
            return tier
    return None


# ---------------------------------------------------------------------------
# LM parameter counts (exact, from the params built on the meta device)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=64)
def _abstract_counts(cfg) -> Dict[str, int]:
    """Param counts by top-level group, and by segment under
    ``"segments/<i>"``."""
    from repro_torch.models.module import ParamFactory, tree_paths
    from repro_torch.models.transformer import DTYPES, LM

    params = LM(cfg, "cpu")._build(
        ParamFactory(None, "meta", DTYPES[cfg.param_dtype]))
    counts: Dict[str, int] = {}
    for path, leaf in tree_paths(params):
        key = path[0] if path[0] != "segments" else f"segments/{path[1]}"
        counts[key] = counts.get(key, 0) + leaf.numel()
    return counts


def arch_param_count(cfg) -> int:
    return sum(_abstract_counts(cfg).values())


def arch_active_param_count(cfg) -> int:
    """Params touched per token (MoE: only the top-k and shared experts)."""
    total = arch_param_count(cfg)
    if not cfg.is_moe:
        return total
    n_moe = sum(1 for k in cfg.layer_kinds() if k == "attn_moe")
    per_expert = 3 * cfg.d_model * cfg.moe_d_ff
    inactive = n_moe * (cfg.num_experts - cfg.experts_per_token) * per_expert
    return total - inactive


def block_param_counts(cfg) -> list:
    """Param count of each SmartFreeze block (layer-range partition)."""
    per_layer = _layer_param_counts(cfg)
    bounds = cfg.block_boundaries()
    return [int(sum(per_layer[lo:hi]))
            for lo, hi in zip(bounds[:-1], bounds[1:])]


def _layer_param_counts(cfg) -> list:
    """Params of each layer: a segment's count over its layers, and the tied
    shared-attention sets amortized over their occurrences."""
    counts = _abstract_counts(cfg)
    kinds = cfg.layer_kinds()
    out = []
    shared_total = counts.get("shared_attn", 0)
    n_shared = sum(1 for k in kinds if k == "shared_attn")
    for i, (kind, n) in enumerate(cfg.segments()):
        if kind == "shared_attn":
            out.extend([shared_total / max(n_shared, 1)] * n)
        else:
            out.extend([counts[f"segments/{i}"] / n] * n)
    return out


# ---------------------------------------------------------------------------
# LM activation, cache and stage bytes
# ---------------------------------------------------------------------------


def layer_activation_bytes(cfg, batch: int, seq: int, kind: str) -> int:
    """Bytes of saved-for-backward intermediates of ONE layer (flash-style
    attention: no S^2 scores; chunked scans for the recurrent kinds)."""
    b = BYTES[cfg.compute_dtype]
    d = cfg.d_model
    tok = batch * seq
    if kind in ("attn_mlp", "attn_moe", "shared_attn"):
        qkv = tok * (cfg.num_heads + 2 * cfg.num_kv_heads) * cfg.head_dim
        if cfg.attention == "mla":
            qkv = tok * (cfg.num_heads * (cfg.qk_nope_dim + cfg.qk_rope_dim)
                         + cfg.kv_lora_rank + cfg.qk_rope_dim
                         + cfg.num_heads * cfg.v_head_dim)
        attn_out = tok * d
        if kind == "attn_moe":
            ff = tok * cfg.experts_per_token * cfg.moe_d_ff * 2
            ff += tok * cfg.num_shared_experts * cfg.moe_d_ff * 2
        else:
            ff = tok * cfg.d_ff * 2  # gate+up (down output is the residual)
        resid = 2 * tok * d  # ln1/ln2 inputs
        return (qkv + attn_out + ff + resid) * b
    if kind in ("mamba2", "mlstm"):
        di = cfg.ssm_expand * d
        proj = tok * 2 * di  # in_proj halves
        states = tok * (di + 2 * cfg.ssm_state)  # conv output
        return (proj + states + tok * d) * b
    if kind == "slstm":
        return (tok * 4 * d + tok * d) * b
    raise ValueError(kind)


def feature_cache_bytes(cfg, num_tokens: int, dtype: Optional[str] = None, *,
                        scale_vectors: int = 0) -> float:
    """Bytes of cached frozen-prefix activations ([*, d_model] at the
    stage's boundary) for ``num_tokens`` tokens, stored at ``dtype`` (None:
    the compute dtype; "float16" / "int8" are the fp16 / int8 tiers). An
    int8 cache adds one f32 scale vector of d_model entries per
    quantization group (``scale_vectors`` of them)."""
    per = (_CACHE_DTYPE_BYTES[dtype] if dtype is not None
           else BYTES[cfg.compute_dtype])
    total = float(num_tokens) * cfg.d_model * per
    if dtype == "int8":
        total += float(scale_vectors) * cfg.d_model * 4.0
    return total


def stage_memory_bytes(cfg, stage: int, batch: int, seq: int, *,
                       optimizer: str = "adamw",
                       op_module_layers: Optional[int] = None,
                       cache_tokens: int = 0,
                       cache_dtype: Optional[str] = None) -> Dict[str, float]:
    """Eq. (4) for SmartFreeze stage ``stage`` (0-based): its terms and
    "total". ``cache_tokens`` adds a client's frozen-prefix feature cache at
    ``cache_dtype`` (its int8 scales one vector per ``seq`` tokens)."""
    bounds = cfg.block_boundaries()
    lo, hi = bounds[stage], bounds[stage + 1]
    kinds = cfg.layer_kinds()
    pb = BYTES[cfg.param_dtype]
    per_layer_params = _layer_param_counts(cfg)
    T = cfg.num_freeze_blocks

    # P(Theta_T): all resident params (frozen prefix + active block + op)
    counts = _abstract_counts(cfg)
    embed_head = counts.get("embed", 0) + counts.get("head", 0) \
        + counts.get("frontend", 0) + counts.get("final_norm", 0)
    resident_layers = sum(per_layer_params[:hi])
    n_op = (op_module_layers if op_module_layers is not None
            else T - stage - 1)
    op_params = n_op * _proxy_layer_params(cfg) + cfg.d_model * cfg.vocab_size
    params_bytes = (resident_layers + embed_head + op_params) * pb

    # A(theta_T) + A(theta_op): activations of the active block and op, x2
    act_active = sum(layer_activation_bytes(cfg, batch, seq, kinds[i])
                     for i in range(lo, hi))
    act_op = n_op * layer_activation_bytes(cfg, batch, seq, "attn_mlp")
    act_term = 2 * (act_active + act_op)

    # optimizer state: active block + op only (AdamW: m+v fp32 + fp32 master)
    opt_mult = {"adamw": 12, "sgd": 4, "sgdm": 8}[optimizer]
    active_params = sum(per_layer_params[lo:hi]) + op_params
    opt_bytes = active_params * opt_mult

    # transient: the largest single-layer activation in the forward
    max_layer = max(layer_activation_bytes(cfg, batch, seq, kinds[i])
                    for i in range(0, hi))
    cache_b = feature_cache_bytes(
        cfg, cache_tokens, cache_dtype,
        scale_vectors=cache_tokens // max(seq, 1)) if cache_tokens else 0.0
    return {"params": params_bytes, "activations": act_term,
            "optimizer": opt_bytes, "max_transient": max_layer,
            "feature_cache": cache_b,
            "total": params_bytes + act_term + opt_bytes + max_layer + cache_b}


def full_model_memory_bytes(cfg, batch: int, seq: int, *,
                            optimizer: str = "adamw") -> Dict[str, float]:
    """Vanilla FL baseline: every layer trained, all activations stored."""
    kinds = cfg.layer_kinds()
    pb = BYTES[cfg.param_dtype]
    total_params = arch_param_count(cfg)
    act = sum(layer_activation_bytes(cfg, batch, seq, k) for k in kinds)
    opt_mult = {"adamw": 12, "sgd": 4, "sgdm": 8}[optimizer]
    max_layer = max(layer_activation_bytes(cfg, batch, seq, k) for k in kinds)
    return {"params": total_params * pb, "activations": 2 * act,
            "optimizer": total_params * opt_mult, "max_transient": max_layer,
            "total": total_params * pb + 2 * act + total_params * opt_mult
            + max_layer}


def _proxy_layer_params(cfg) -> int:
    """Output-module proxy layer: attention + slim MLP (d_ff = d_model)."""
    d = cfg.d_model
    attn = d * cfg.num_heads * cfg.head_dim * 2 \
        + d * cfg.num_kv_heads * cfg.head_dim * 2
    return attn + 3 * d * d


# ---------------------------------------------------------------------------
# LM FLOPs (Eq. 5): per-token forward FLOPs per layer, and stage totals
# ---------------------------------------------------------------------------


def layer_fwd_flops_per_token(cfg, kind: str, seq: int) -> float:
    d = cfg.d_model
    if kind in ("attn_mlp", "attn_moe", "shared_attn"):
        if cfg.attention == "mla":
            qk_d = cfg.qk_nope_dim + cfg.qk_rope_dim
            proj = 2 * d * (cfg.q_lora_rank or d) \
                + 2 * cfg.q_lora_rank * cfg.num_heads * qk_d \
                if cfg.q_lora_rank else 2 * d * cfg.num_heads * qk_d
            proj += 2 * d * (cfg.kv_lora_rank + cfg.qk_rope_dim)
            proj += 2 * cfg.kv_lora_rank * cfg.num_heads \
                * (cfg.qk_nope_dim + cfg.v_head_dim)
            proj += 2 * cfg.num_heads * cfg.v_head_dim * d
            attn_core = 2 * 2 * cfg.num_heads * qk_d * seq / 2  # causal avg
        else:
            proj = 2 * d * (cfg.num_heads + 2 * cfg.num_kv_heads) \
                * cfg.head_dim + 2 * cfg.num_heads * cfg.head_dim * d
            attn_core = 2 * 2 * cfg.num_heads * cfg.head_dim * seq / 2
        if kind == "attn_moe":
            ff = 2 * 3 * d * cfg.moe_d_ff * (cfg.experts_per_token
                                             + cfg.num_shared_experts)
            ff += 2 * d * cfg.num_experts  # router
        else:
            ff = 2 * 3 * d * cfg.d_ff
        return proj + attn_core + ff
    if kind == "mamba2":
        di = cfg.ssm_expand * d
        H = di // cfg.ssm_head_dim
        proj = 2 * d * (2 * di + 2 * cfg.ssm_state + H) + 2 * di * d
        scan = 2 * 3 * di * cfg.ssm_state  # state update + readout
        return proj + scan
    if kind == "mlstm":
        di = cfg.ssm_expand * d
        proj = 2 * d * 2 * di + 2 * 3 * di * di + 2 * di * d
        hd = di // max(cfg.num_heads, 1)
        scan = 2 * 3 * di * hd  # matrix-memory update/readout per token
        return proj + scan
    if kind == "slstm":
        hd = d // max(cfg.num_heads, 1)
        return 2 * d * 4 * d + 2 * max(cfg.num_heads, 1) * hd * 4 * hd \
            + 2 * 2 * d * int(d * 4 / 3)
    raise ValueError(kind)


def stage_flops(cfg, stage: int, batch: int, seq: int) -> Dict[str, float]:
    """Eq. (5): FLOPs_T = fwd(frozen prefix + active + op) + bwd(active +
    op)."""
    bounds = cfg.block_boundaries()
    lo, hi = bounds[stage], bounds[stage + 1]
    kinds = cfg.layer_kinds()
    tok = batch * seq
    n_op = cfg.num_freeze_blocks - stage - 1
    fwd_frozen = sum(layer_fwd_flops_per_token(cfg, kinds[i], seq)
                     for i in range(lo))
    fwd_active = sum(layer_fwd_flops_per_token(cfg, kinds[i], seq)
                     for i in range(lo, hi))
    fwd_op = n_op * layer_fwd_flops_per_token(cfg, "attn_mlp", seq) * 0.5
    head = 2 * cfg.d_model * cfg.vocab_size
    fwd = (fwd_frozen + fwd_active + fwd_op + head) * tok
    bwd = 2 * (fwd_active + fwd_op + head) * tok  # bwd ~ 2x fwd, active only
    return {"fwd": fwd, "bwd": bwd, "total": fwd + bwd}


def full_model_flops(cfg, batch: int, seq: int) -> float:
    kinds = cfg.layer_kinds()
    tok = batch * seq
    per_tok = sum(layer_fwd_flops_per_token(cfg, k, seq) for k in kinds)
    head = 2 * cfg.d_model * cfg.vocab_size
    return (per_tok + head) * tok * 3  # fwd + 2x bwd


def model_flops_6nd(cfg, batch: int, seq: int) -> float:
    """MODEL_FLOPS = 6 N D (dense) or 6 N_active D (MoE)."""
    return 6.0 * arch_active_param_count(cfg) * batch * seq


# ---------------------------------------------------------------------------
# CNN testbed
# ---------------------------------------------------------------------------


def cnn_feature_cache_bytes(model, stage: int, num_samples: int,
                            image_size: int = 32,
                            dtype: str = "float32") -> float:
    """Bytes to hold a client shard's frozen-prefix activations: the
    feature map at the stage boundary, one per local sample, at ``dtype``.
    An int8 cache adds one f32 scale per (sample, channel)."""
    if stage <= 0:
        return 0.0
    cfg = model.cfg
    ch = cfg.stage_channels[stage - 1]
    if cfg.kind == "vgg":  # maxpool halves after every stage
        res = max(image_size // (2 ** stage), 1)
    else:  # resnet: stride-2 at each stage entry except stage 0
        res = max(image_size // (2 ** (stage - 1)), 1)
    total = float(num_samples) * res * res * ch * _CACHE_DTYPE_BYTES[dtype]
    if dtype == "int8":
        total += float(num_samples) * ch * 4.0
    return total


def cnn_stage_memory_bytes(model, stage: int, batch_size: int,
                           image_size: int = 32, *,
                           cache_samples: int = 0,
                           cache_dtype: str = "float32") -> float:
    """Eq. (4) for the CNN testbed (fp32). ``cache_samples`` adds the
    client's frozen-prefix feature cache at ``cache_dtype``, which the
    server uses to decline the cache on memory-poor clients."""
    cfg = model.cfg
    res = image_size
    act = 0.0
    max_act = 0.0
    params = 0.0
    for i, (nb, ch) in enumerate(zip(cfg.stage_sizes, cfg.stage_channels)):
        r = res // (2 ** i) if cfg.kind == "vgg" else max(res // (2 ** max(i, 0)), 4)
        a = batch_size * r * r * ch * 4.0 * nb * 2  # convs per stage
        max_act = max(max_act, a / max(nb, 1))
        c_in = cfg.stage_channels[max(i - 1, 0)]
        params += nb * (9 * c_in * ch + 9 * ch * ch) * 4.0
        if i == stage:
            act = a
        if i >= stage:
            break
    opt = params * 2.0  # momentum
    total = 2 * act + params + opt + max_act
    if cache_samples:
        total += cnn_feature_cache_bytes(model, stage, cache_samples,
                                         image_size, cache_dtype)
    return total
