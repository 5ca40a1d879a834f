"""GQA attention, full sequence (counterpart of the GQA part of
``repro/models/attention.py``).

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

The reference's sharding constraints do nothing on one device and are
left out. MLA is not ported (ROADMAP A15).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.utils.checkpoint as ckpt

from repro_torch.kernels import ops
from repro_torch.models.layers import apply_rope, dense, dense_init
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


def _check_gqa(cfg) -> None:
    if cfg.attention != "gqa":
        raise NotImplementedError(f"{cfg.attention!r} attention is not ported "
                                  "(ROADMAP A15)")


def attn_init(fac: ParamFactory, cfg) -> Params:
    _check_gqa(cfg)
    return gqa_init(fac, cfg)


def attn_forward(p: Params, x: torch.Tensor, cfg, *,
                 positions: Optional[torch.Tensor] = None,
                 causal: bool = True) -> torch.Tensor:
    _check_gqa(cfg)
    return gqa_forward(p, x, cfg, positions=positions, causal=causal)


def attn_init_cache(cfg, batch: int, max_seq: int, dtype, device) -> Params:
    _check_gqa(cfg)
    return gqa_init_cache(cfg, batch, max_seq, dtype, device)


def attn_decode(p: Params, x: torch.Tensor, cache: Params, pos: int, cfg, *,
                steps: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                ) -> Tuple[torch.Tensor, Params]:
    _check_gqa(cfg)
    return gqa_decode(p, x, cache, pos, cfg, steps=steps)
