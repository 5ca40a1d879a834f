"""Attention (counterpart of ``repro/models/attention.py``): GQA and MLA
(multi-head latent attention), each full-sequence and one-token decode.

Dispatch follows the tensor's device. On the card every full-sequence GQA
attention goes through the flash kernel (``kernels/ops.py:flash_attention``,
kernel B4), whatever ``cfg.attention_impl`` says, as every other kernel of
the port does. On the CPU the path the config names runs:

  * ``"xla"``: the dense softmax below ``ATTN_BLOCK_THRESHOLD`` tokens, the
    blockwise online softmax at and above it, as the reference's XLA path;
  * ``"pallas"``: the flash kernel's plain version through its
    ``autograd.Function``, as the reference's Pallas path.

k and v go to the kernel unrepeated ([B, S, Hkv, d]); it maps q head h to
kv head h // (Hq / Hkv), as the Pallas index maps do. The reference repeats
kv to Hq heads first and so runs its kernel with a group of 1; the values
are the same and the card moves a quarter of the kv bytes.

One-token decode (``gqa_decode``) writes the new k/v row into the
preallocated cache in place (the reference's ``dynamic_update_slice``
returns a new cache). On the card it attends through the flash-decode
kernel (``kernels/ops.py:flash_decode``, kernel B6) over the whole cache
with ``length = pos + 1``; on the CPU it runs the reference's einsum path.

MLA (MiniCPM3, DeepSeek-V2) calls no kernel, as the reference's MLA calls
none: its full-sequence forward expands k/v from the latent and runs the
dense softmax below ``ATTN_BLOCK_THRESHOLD`` tokens and
``blockwise_attention`` (q.k width nope + rope, v width ``v_head_dim``)
at and above it, on both devices; its decode is matrix-absorbed (scores
in the kv_lora latent space) and writes the new ``ckv`` and ``kpe`` rows
into the preallocated cache in place. Both round the scores to the
compute dtype where the reference does, before they become f32.

The reference's sharding constraints do nothing on one device and are
left out.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.utils.checkpoint as ckpt

from repro_torch.kernels import ops
from repro_torch.models.layers import (apply_rope, dense, dense_init,
                                       rmsnorm, rmsnorm_init)
from repro_torch.models.module import ParamFactory, Params

NEG_INF = -1e9  # mask value of the XLA paths (finite, as in the reference)
ATTN_BLOCK_THRESHOLD = 2048
BLOCK_Q = 512
BLOCK_K = 1024


def gqa_init(fac: ParamFactory, cfg) -> Params:
    d, nq, nkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return {"wq": dense_init(fac, d, nq * hd, bias=cfg.qkv_bias),
            "wk": dense_init(fac, d, nkv * hd, bias=cfg.qkv_bias),
            "wv": dense_init(fac, d, nkv * hd, bias=cfg.qkv_bias),
            "wo": dense_init(fac, nq * hd, d)}


def _split_heads(x: torch.Tensor, n: int) -> torch.Tensor:
    return x.reshape(*x.shape[:-1], n, x.shape[-1] // n)


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool, scale: float, block_q: int = BLOCK_Q,
                        block_k: int = BLOCK_K) -> torch.Tensor:
    """Online-softmax attention that never holds the S x S scores:
    q, k: [B, S, H, dk]; v: [B, S, H, dv] -> [B, S, H, dv]. Each kv step is
    checkpointed, as ``jax.checkpoint`` does in the reference."""
    B, S, H, dk = q.shape
    dv = v.shape[-1]
    bq = min(block_q, S)
    while S % bq:
        bq //= 2
    bk = min(block_k, S)
    while S % bk:
        bk //= 2
    dev = q.device

    def kv_step(m, l, acc, qblk, kblk, vblk, qi, kj):
        s = torch.einsum("bqhd,bkhd->bhqk", qblk, kblk).float() * scale
        if causal:
            pos_q = qi * bq + torch.arange(bq, device=dev)
            pos_k = kj * bk + torch.arange(bk, device=dev)
            s = s.masked_fill(pos_q[:, None] < pos_k[None, :], NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l_new = l * corr + p.sum(dim=-1)
        acc_new = acc * corr[..., None] + torch.einsum(
            "bhqk,bkhd->bhqd", p.to(qblk.dtype), vblk).float()
        return m_new, l_new, acc_new

    outs = []
    for qi in range(S // bq):
        qblk = q[:, qi * bq:(qi + 1) * bq]
        m = torch.full((B, H, bq), -math.inf, device=dev)
        l = torch.zeros((B, H, bq), device=dev)
        acc = torch.zeros((B, H, bq, dv), device=dev)
        for kj in range(S // bk):
            kblk, vblk = k[:, kj * bk:(kj + 1) * bk], v[:, kj * bk:(kj + 1) * bk]
            m, l, acc = ckpt.checkpoint(kv_step, m, l, acc, qblk, kblk, vblk,
                                        qi, kj, use_reentrant=False)
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        outs.append(out.transpose(1, 2).to(q.dtype))
    return torch.cat(outs, dim=1)


def gqa_forward(p: Params, x: torch.Tensor, cfg, *,
                positions: Optional[torch.Tensor] = None,
                causal: bool = True) -> torch.Tensor:
    """Full-sequence attention. x: [B, S, D] -> [B, S, D]."""
    B, S, _ = x.shape
    nq, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    q = apply_rope(_split_heads(dense(p["wq"], x), nq), positions, cfg.rope_theta)
    k = apply_rope(_split_heads(dense(p["wk"], x), nkv), positions, cfg.rope_theta)
    v = _split_heads(dense(p["wv"], x), nkv)
    scale = 1.0 / math.sqrt(hd)
    if x.device.type == "cuda" or cfg.attention_impl == "pallas":
        out = ops.flash_attention(q, k, v.contiguous(), causal, scale)
    else:
        g = nq // nkv
        k = k.repeat_interleave(g, dim=2)
        v = v.repeat_interleave(g, dim=2)
        if S >= ATTN_BLOCK_THRESHOLD:
            out = blockwise_attention(q, k, v, causal=causal, scale=scale)
        else:
            scores = torch.einsum("bsnh,btnh->bnst", q, k).float() * scale
            if causal:
                mask = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
                scores = scores.masked_fill(~mask, NEG_INF)
            probs = torch.softmax(scores, dim=-1).to(x.dtype)
            out = torch.einsum("bnst,btnh->bsnh", probs, v)
    return dense(p["wo"], out.reshape(B, S, nq * hd))


def gqa_init_cache(cfg, batch: int, max_seq: int, dtype, device) -> Params:
    nkv, hd = cfg.num_kv_heads, cfg.head_dim
    return {"k": torch.zeros((batch, max_seq, nkv, hd), dtype=dtype,
                             device=device),
            "v": torch.zeros((batch, max_seq, nkv, hd), dtype=dtype,
                             device=device)}


def decode_positions(batch: int, pos: int, device
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(positions [B, 1], length [B]) int32 on ``device`` for a token at
    ``pos``: built once a step and shared by every layer."""
    return (torch.full((batch, 1), pos, dtype=torch.int32, device=device),
            torch.full((batch,), pos + 1, dtype=torch.int32, device=device))


def gqa_decode(p: Params, x: torch.Tensor, cache: Params, pos: int, cfg, *,
               steps: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
               ) -> Tuple[torch.Tensor, Params]:
    """One-token decode. x: [B, 1, D]; ``pos``, a host integer, is the new
    token's index; ``steps`` is ``decode_positions(B, pos, x.device)``,
    built here when the caller has not. Writes its k/v row into ``cache``
    ([B, S, Hkv, d] each) in place and returns (out [B, 1, D], cache)."""
    B = x.shape[0]
    nq, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    g = nq // nkv
    S = cache["k"].shape[1]
    pos = int(pos)
    if steps is None:
        steps = decode_positions(B, pos, x.device)
    positions, length = steps
    q = apply_rope(_split_heads(dense(p["wq"], x), nq), positions,
                   cfg.rope_theta)
    k_new = apply_rope(_split_heads(dense(p["wk"], x), nkv), positions,
                       cfg.rope_theta)
    v_new = _split_heads(dense(p["wv"], x), nkv)
    k, v = cache["k"], cache["v"]
    k[:, pos] = k_new[:, 0].to(k.dtype)
    v[:, pos] = v_new[:, 0].to(v.dtype)
    if x.device.type == "cuda":
        # the whole cache (a contiguous [B, S, Hkv, d] view); the kernel
        # reads only rows < length, built on the device: no host sync
        out = ops.flash_decode(q[:, 0].contiguous(), k, v, length)
    else:
        # the reference's math: scores and probabilities rounded to the
        # compute dtype where it rounds them
        qg = q.reshape(B, 1, nkv, g, hd)
        scores = torch.einsum("bqkgh,bskh->bkgqs", qg, k).float()
        scores = scores / math.sqrt(hd)
        valid = torch.arange(S, device=x.device) <= pos
        scores = scores.masked_fill(~valid, NEG_INF)
        probs = torch.softmax(scores, dim=-1).to(x.dtype)
        out = torch.einsum("bkgqs,bskh->bqkgh", probs, v)
    return dense(p["wo"], out.reshape(B, 1, nq * hd)), cache


# ===========================================================================
# MLA (multi-head latent attention)
# ===========================================================================


def mla_init(fac: ParamFactory, cfg) -> Params:
    d, nh = cfg.d_model, cfg.num_heads
    nope, rope_d, vd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    p: Params = {}
    if cfg.q_lora_rank > 0:
        p["wq_a"] = dense_init(fac, d, cfg.q_lora_rank)
        p["q_norm"] = rmsnorm_init(fac, cfg.q_lora_rank)
        p["wq_b"] = dense_init(fac, cfg.q_lora_rank, nh * (nope + rope_d))
    else:
        p["wq"] = dense_init(fac, d, nh * (nope + rope_d))
    p["wkv_a"] = dense_init(fac, d, cfg.kv_lora_rank + rope_d)
    p["kv_norm"] = rmsnorm_init(fac, cfg.kv_lora_rank)
    p["wkv_b"] = dense_init(fac, cfg.kv_lora_rank, nh * (nope + vd))
    p["wo"] = dense_init(fac, nh * vd, d)
    return p


def _mla_q(p: Params, x: torch.Tensor, cfg, positions
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(q_nope [..., nh, nope], roped q_pe [..., nh, rope])."""
    nh, nope, rope_d = cfg.num_heads, cfg.qk_nope_dim, cfg.qk_rope_dim
    if cfg.q_lora_rank > 0:
        q = dense(p["wq_b"], rmsnorm(p["q_norm"], dense(p["wq_a"], x),
                                     cfg.norm_eps))
    else:
        q = dense(p["wq"], x)
    q = q.reshape(*x.shape[:-1], nh, nope + rope_d)
    return q[..., :nope], apply_rope(q[..., nope:], positions, cfg.rope_theta)


def _mla_kv_latent(p: Params, x: torch.Tensor, cfg, positions
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The compressed cache entries: normed c_kv [B, S, kv_lora] and the
    roped k_pe [B, S, rope] of the one head that every q head shares."""
    kv_a = dense(p["wkv_a"], x)
    c_kv = rmsnorm(p["kv_norm"], kv_a[..., :cfg.kv_lora_rank], cfg.norm_eps)
    k_pe = kv_a[..., cfg.kv_lora_rank:]
    k_pe = apply_rope(k_pe[..., None, :], positions, cfg.rope_theta)[..., 0, :]
    return c_kv, k_pe


def mla_forward(p: Params, x: torch.Tensor, cfg, *,
                positions: Optional[torch.Tensor] = None,
                causal: bool = True) -> torch.Tensor:
    """Full-sequence MLA with k/v expanded from the latent. x: [B, S, D]
    -> [B, S, D]."""
    B, S, _ = x.shape
    nh, nope, rope_d = cfg.num_heads, cfg.qk_nope_dim, cfg.qk_rope_dim
    vd = cfg.v_head_dim
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    q_nope, q_pe = _mla_q(p, x, cfg, positions)
    c_kv, k_pe = _mla_kv_latent(p, x, cfg, positions)
    kv = dense(p["wkv_b"], c_kv).reshape(B, S, nh, nope + vd)
    k_nope, v = kv[..., :nope], kv[..., nope:]
    scale = 1.0 / math.sqrt(nope + rope_d)
    if S >= ATTN_BLOCK_THRESHOLD:
        # the shared rope head folded into every head's k: q' = [q_nope |
        # q_pe], k' = [k_nope | k_pe]
        k_pe_b = k_pe[:, :, None, :].expand(B, S, nh, rope_d)
        out = blockwise_attention(torch.cat([q_nope, q_pe], dim=-1),
                                  torch.cat([k_nope, k_pe_b], dim=-1), v,
                                  causal=causal, scale=scale)
    else:
        # two products in the compute dtype, their sum rounded there too,
        # then f32
        scores = (torch.einsum("bsnh,btnh->bnst", q_nope, k_nope)
                  + torch.einsum("bsnh,bth->bnst", q_pe, k_pe)).float() * scale
        if causal:
            mask = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
            scores = scores.masked_fill(~mask, NEG_INF)
        probs = torch.softmax(scores, dim=-1).to(x.dtype)
        out = torch.einsum("bnst,btnh->bsnh", probs, v)
    return dense(p["wo"], out.reshape(B, S, nh * vd))


def mla_init_cache(cfg, batch: int, max_seq: int, dtype, device) -> Params:
    return {"ckv": torch.zeros((batch, max_seq, cfg.kv_lora_rank),
                               dtype=dtype, device=device),
            "kpe": torch.zeros((batch, max_seq, cfg.qk_rope_dim),
                               dtype=dtype, device=device)}


def mla_decode(p: Params, x: torch.Tensor, cache: Params, pos: int, cfg, *,
               steps: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
               ) -> Tuple[torch.Tensor, Params]:
    """Matrix-absorbed one-token decode: attention runs in the kv_lora
    latent space, and the cache holds only the latents. x: [B, 1, D];
    ``pos`` and ``steps`` as ``gqa_decode``'s. Writes the new ``ckv`` and
    ``kpe`` rows into ``cache`` in place and returns (out [B, 1, D],
    cache)."""
    B = x.shape[0]
    nh, nope, rope_d = cfg.num_heads, cfg.qk_nope_dim, cfg.qk_rope_dim
    vd, lora = cfg.v_head_dim, cfg.kv_lora_rank
    pos = int(pos)
    if steps is None:
        steps = decode_positions(B, pos, x.device)
    positions = steps[0]
    q_nope, q_pe = _mla_q(p, x, cfg, positions)  # [B, 1, nh, nope / rope]
    c_new, kpe_new = _mla_kv_latent(p, x, cfg, positions)
    ckv, kpe = cache["ckv"], cache["kpe"]
    ckv[:, pos] = c_new[:, 0].to(ckv.dtype)
    kpe[:, pos] = kpe_new[:, 0].to(kpe.dtype)
    S = ckv.shape[1]
    wkv_b = p["wkv_b"]["w"].reshape(lora, nh, nope + vd).to(x.dtype)
    wk_b, wv_b = wkv_b[..., :nope], wkv_b[..., nope:]
    # the k projection absorbed into q: q_lat [B, 1, nh, lora]
    q_lat = torch.einsum("bqnd,lnd->bqnl", q_nope, wk_b)
    scale = 1.0 / torch.sqrt(torch.tensor(float(nope + rope_d)))
    scores = (torch.einsum("bqnl,bsl->bnqs", q_lat, ckv)
              + torch.einsum("bqnh,bsh->bnqs", q_pe, kpe)).float() * scale
    valid = torch.arange(S, device=x.device) <= pos
    scores = scores.masked_fill(~valid, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    out_lat = torch.einsum("bnqs,bsl->bqnl", probs, ckv)
    out = torch.einsum("bqnl,lnd->bqnd", out_lat, wv_b).reshape(B, 1, nh * vd)
    return dense(p["wo"], out), cache


# ===========================================================================
# Dispatch by cfg.attention
# ===========================================================================


def attn_init(fac: ParamFactory, cfg) -> Params:
    return mla_init(fac, cfg) if cfg.attention == "mla" else gqa_init(fac, cfg)


def attn_forward(p: Params, x: torch.Tensor, cfg, *,
                 positions: Optional[torch.Tensor] = None,
                 causal: bool = True) -> torch.Tensor:
    fn = mla_forward if cfg.attention == "mla" else gqa_forward
    return fn(p, x, cfg, positions=positions, causal=causal)


def attn_init_cache(cfg, batch: int, max_seq: int, dtype, device) -> Params:
    fn = mla_init_cache if cfg.attention == "mla" else gqa_init_cache
    return fn(cfg, batch, max_seq, dtype, device)


def attn_decode(p: Params, x: torch.Tensor, cache: Params, pos: int, cfg, *,
                steps: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                ) -> Tuple[torch.Tensor, Params]:
    fn = mla_decode if cfg.attention == "mla" else gqa_decode
    return fn(p, x, cache, pos, cfg, steps=steps)
