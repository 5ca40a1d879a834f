"""The LM: embed -> segments of stacked layers -> head (counterpart of
``repro/models/transformer.py``), for the dense family (GQA or MLA
attention), the MoE family (attention with a mixture-of-experts FFN,
``models/moe.py``, after ``first_dense_layers`` dense layers), the hybrid
Zamba2 family (Mamba2 layers and weight-tied shared attention) and the
xLSTM family (mLSTM layers, every ``slstm_every``-th an sLSTM).

``LM`` exposes the decomposed interface SmartFreeze's progressive trainer
needs: ``embed`` / ``run_layers(lo, hi)`` / ``head``. Layers are stored
stacked (every leaf has a leading [n_layers] dim, as the reference's scan
wants), and ``run_layers`` walks a Python loop over slices of the stack.
A hybrid model's shared-attention segments own no params: their layers use
``params["shared_attn"][set]``, the sets alternating by occurrence.

The modality stubs sit in front of the layers. InternVL2's
(``vision_stub``) projects precomputed patch embeddings through proj1,
``jax.nn.gelu``'s tanh form in the compute dtype (``layers.gelu``) and
proj2, and puts those positions in front of the text's token embeddings;
the loss reads only the text positions. HuBERT's (``audio_stub``)
projects frame features through one dense layer and has no token embed on
its forward path; the encoder runs its attention non-causal.

``init_cache`` / ``decode_step`` are the one-token decode the serving
loop (``launch/serve.py``) steps: the caches are preallocated per
segment (stacked [n_layers, ...] for a segment of layers, one KV cache per
shared-attention occurrence) and each step writes its k/v rows, MLA
latents and recurrent states into them in place, returning the same dict.
A decode step always embeds its token with the token embed, as the
reference's does, for the stub modalities too (an encoder-only model then
decodes causally over its cache).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import torch
import torch.utils.checkpoint as ckpt

from repro_torch._device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (activation, dense, dense_init, gelu,
                                       norm, norm_init)
from repro_torch.models.module import ParamFactory, Params, init_stack

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _dt(name: str) -> torch.dtype:
    return DTYPES[name]


ATTN_KINDS = ("attn_mlp", "attn_moe", "shared_attn")
# the recurrent kinds: (init, full-sequence forward, state init, one step)
RECURRENT = {
    "mamba2": (ssm_mod.mamba2_init, ssm_mod.mamba2_forward,
               ssm_mod.mamba2_init_state, ssm_mod.mamba2_step),
    "mlstm": (ssm_mod.mlstm_init, ssm_mod.mlstm_forward,
              ssm_mod.mlstm_init_state, ssm_mod.mlstm_step),
    "slstm": (ssm_mod.slstm_init, ssm_mod.slstm_forward,
              ssm_mod.slstm_init_state, ssm_mod.slstm_step),
}


def _check_kind(kind: str) -> None:
    if kind not in ATTN_KINDS and kind not in RECURRENT:
        raise ValueError(kind)


def mlp_init(fac: ParamFactory, cfg, d_ff: int) -> Params:
    d = cfg.d_model
    return {"gate": dense_init(fac, d, d_ff), "up": dense_init(fac, d, d_ff),
            "down": dense_init(fac, d_ff, d)}


def mlp_apply(p: Params, x: torch.Tensor, cfg) -> torch.Tensor:
    act = activation(cfg.mlp_activation)
    return dense(p["down"], act(dense(p["gate"], x)) * dense(p["up"], x))


def layer_init(fac: ParamFactory, cfg, kind: str) -> Params:
    _check_kind(kind)
    if kind in RECURRENT:
        return {"ln": norm_init(fac, cfg.d_model, cfg.norm),
                "mix": RECURRENT[kind][0](fac, cfg)}
    p = {"ln1": norm_init(fac, cfg.d_model, cfg.norm),
         "attn": attn.attn_init(fac, cfg),
         "ln2": norm_init(fac, cfg.d_model, cfg.norm)}
    if kind == "attn_moe":
        p["moe"] = moe_mod.moe_init(fac, cfg)
    else:
        p["mlp"] = mlp_init(fac, cfg, cfg.d_ff)
    return p


def layer_apply(p: Params, x: torch.Tensor, cfg, kind: str, *,
                causal: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence layer. Returns (y, aux_loss); the aux loss is the MoE
    FFN's load-balancing loss for ``attn_moe``, 0 for every other kind."""
    _check_kind(kind)
    aux = torch.zeros((), device=x.device)
    if kind in RECURRENT:
        return x + RECURRENT[kind][1](
            p["mix"], norm(p["ln"], x, cfg.norm, cfg.norm_eps), cfg), aux
    h = x + attn.attn_forward(p["attn"], norm(p["ln1"], x, cfg.norm,
                                              cfg.norm_eps), cfg, causal=causal)
    hn = norm(p["ln2"], h, cfg.norm, cfg.norm_eps)
    if kind == "attn_moe":
        y, aux = moe_mod.moe_forward(p["moe"], hn, cfg)
    else:
        y = mlp_apply(p["mlp"], hn, cfg)
    return h + y, aux


def layer_init_cache(cfg, kind: str, batch: int, max_seq: int, dtype,
                     device) -> Params:
    _check_kind(kind)
    if kind in RECURRENT:
        return RECURRENT[kind][2](cfg, batch, dtype, device)
    return attn.attn_init_cache(cfg, batch, max_seq, dtype, device)


def layer_decode(p: Params, x: torch.Tensor, cache: Params, pos: int, cfg,
                 kind: str, *, steps=None) -> Tuple[torch.Tensor, Params]:
    """One-token layer. x: [B, 1, D]; ``steps`` as ``attn.gqa_decode``'s.
    Writes the layer's cache or state in place and returns (y, cache)."""
    _check_kind(kind)
    if kind in RECURRENT:
        y, cache = RECURRENT[kind][3](
            p["mix"], norm(p["ln"], x, cfg.norm, cfg.norm_eps), cache, cfg)
        return x + y, cache
    a, cache = attn.attn_decode(p["attn"], norm(p["ln1"], x, cfg.norm,
                                                cfg.norm_eps), cache, pos, cfg,
                                steps=steps)
    h = x + a
    hn = norm(p["ln2"], h, cfg.norm, cfg.norm_eps)
    y = (moe_mod.moe_decode(p["moe"], hn, cfg) if kind == "attn_moe"
         else mlp_apply(p["mlp"], hn, cfg))
    return h + y, cache


def layer_at(stacked: Params, i: int) -> Params:
    """Layer i of a stacked tree (views)."""
    if isinstance(stacked, dict):
        return {k: layer_at(v, i) for k, v in stacked.items()}
    return stacked[i]


@dataclass
class LM:
    """``device`` is where ``init`` places the params and ``init_cache``
    the KV caches; it defaults to the card and raises when CUDA is absent
    (tests pass ``device="cpu"``)."""
    cfg: object
    device: torch.device = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device)

    def _build(self, fac: ParamFactory) -> Params:
        cfg = self.cfg
        p: Params = {"embed": fac.param((cfg.vocab_size, cfg.d_model),
                                        init="embed", scale=0.02)}
        if cfg.modality == "vision_stub":
            p["frontend"] = {
                "proj1": dense_init(fac, cfg.frontend_dim, cfg.d_model),
                "proj2": dense_init(fac, cfg.d_model, cfg.d_model)}
        elif cfg.modality == "audio_stub":
            p["frontend"] = {
                "proj": dense_init(fac, cfg.frontend_dim, cfg.d_model)}
        # shared-attention segments own no params (the reference's tree)
        p["segments"] = {str(i): {} if kind == "shared_attn" else
                         init_stack(fac, n, lambda f, k=kind:
                                    layer_init(f, cfg, k))
                         for i, (kind, n) in enumerate(cfg.segments())}
        if any(k == "shared_attn" for k, _ in cfg.segments()):
            p["shared_attn"] = {
                str(j): layer_init(fac, cfg, "shared_attn")
                for j in range(max(cfg.num_shared_attn_sets, 1))}
        p["final_norm"] = norm_init(fac, cfg.d_model, cfg.norm)
        if not cfg.tie_embeddings:
            p["head"] = dense_init(fac, cfg.d_model, cfg.vocab_size)
        return p

    def init(self, generator: torch.Generator) -> Params:
        """Params in ``cfg.param_dtype`` on the model's device, drawn from
        ``generator`` on the generator's own device."""
        return self._build(ParamFactory(generator, self.device,
                                        _dt(self.cfg.param_dtype)))

    def _seg_table(self) -> List[Tuple[str, int, int, int]]:
        """(kind, seg_index, layer_lo, layer_hi) per segment."""
        out, lo = [], 0
        for i, (kind, n) in enumerate(self.cfg.segments()):
            out.append((kind, i, lo, lo + n))
            lo += n
        return out

    def _shared_attn_index(self, layer_idx: int) -> int:
        """The tied weight set of the shared-attention layer at
        ``layer_idx``: occurrences alternate over the sets."""
        occ = sum(k == "shared_attn"
                  for k in self.cfg.layer_kinds()[:layer_idx])
        return occ % max(self.cfg.num_shared_attn_sets, 1)

    def _layers(self, params: Params, kind: str, si: int, s_lo: int, i: int
                ) -> Params:
        """The params of layer ``s_lo + i`` of segment ``si``."""
        if kind == "shared_attn":
            return params["shared_attn"][str(self._shared_attn_index(s_lo))]
        return layer_at(params["segments"][str(si)], i)

    def embed(self, params: Params, batch: Dict) -> torch.Tensor:
        """[B, S, d_model] in the compute dtype. Audio: the frames'
        projection. Vision: the patches' projection (when the batch has
        them) in front of the tokens' embeddings."""
        cfg = self.cfg
        cdt = _dt(cfg.compute_dtype)
        if cfg.modality == "audio_stub":
            return dense(params["frontend"]["proj"], batch["frames"].to(cdt))
        h = params["embed"][batch["tokens"]].to(cdt)
        if cfg.modality == "vision_stub" and "patches" in batch:
            fp = params["frontend"]
            pe = dense(fp["proj2"], gelu(dense(fp["proj1"],
                                               batch["patches"].to(cdt))))
            h = torch.cat([pe, h], dim=1)
        return h

    def run_layers(self, params: Params, h: torch.Tensor, lo: int, hi: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Run layers [lo, hi) full-sequence. Returns (h, aux_loss)."""
        causal = not self.cfg.is_encoder_only
        aux = torch.zeros((), device=h.device)
        for kind, si, s_lo, s_hi in self._seg_table():
            for i in range(max(lo, s_lo), min(hi, s_hi)):
                h, al = layer_apply(self._layers(params, kind, si, s_lo,
                                                 i - s_lo),
                                    h, self.cfg, kind, causal=causal)
                aux = aux + al
        return h, aux

    def head(self, params: Params, h: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        h = norm(params["final_norm"], h, cfg.norm, cfg.norm_eps)
        if cfg.tie_embeddings:
            return h @ params["embed"].T.to(h.dtype)
        return dense(params["head"], h)

    def forward(self, params: Params, batch: Dict
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Full forward. Returns (logits, aux_loss)."""
        h, aux = self.run_layers(params, self.embed(params, batch), 0,
                                 self.cfg.num_layers)
        return self.head(params, h), aux

    def loss(self, params: Params, batch: Dict) -> torch.Tensor:
        """Chunked-CE loss: never holds [B, S, V] logits."""
        cfg = self.cfg
        h, aux = self.run_layers(params, self.embed(params, batch), 0,
                                 cfg.num_layers)
        h = norm(params["final_norm"], h, cfg.norm, cfg.norm_eps)
        head_w = params["embed"].T if cfg.tie_embeddings else params["head"]["w"]
        return chunked_ce_loss(h, head_w, batch, cfg) + 0.01 * aux


    # ----- decode -----

    def init_cache(self, batch: int, max_seq: int) -> Dict:
        """Zeroed caches on the model's device, per segment: a stack for a
        segment of layers ({"k", "v"} of [n_layers, batch, max_seq, Hkv, d]
        in the compute dtype; MLA's {"ckv", "kpe"} of [n_layers, batch,
        max_seq, kv_lora / rope]; the recurrent kinds' states, f32 but for
        "conv": Mamba2's {"h", "conv"}, mLSTM's {"C", "n", "m", "conv"},
        sLSTM's {"c", "n", "h", "m", "conv"}), one unstacked KV cache for a
        shared-attention occurrence. Every leaf is zero, xLSTM's "m"
        stabilizers too, as the reference's stacked caches are (its
        one-layer state inits start "m" at -inf)."""
        cfg = self.cfg
        dtype = _dt(cfg.compute_dtype)
        caches = {}
        for kind, si, s_lo, s_hi in self._seg_table():
            if kind == "shared_attn":
                caches[str(si)] = layer_init_cache(cfg, kind, batch, max_seq,
                                                   dtype, self.device)
                continue
            # one layer's cache on the meta device gives the shapes, as the
            # reference's eval_shape does
            one = layer_init_cache(cfg, kind, batch, max_seq, dtype, "meta")
            caches[str(si)] = {
                k: torch.zeros((s_hi - s_lo,) + tuple(t.shape), dtype=t.dtype,
                               device=self.device) for k, t in one.items()}
        return caches

    def decode_step(self, params: Params, batch: Dict, cache: Dict, pos: int
                    ) -> Tuple[torch.Tensor, Dict]:
        """One-token decode. batch['tokens']: [B, 1]; ``pos`` (a host
        integer) is its position. Writes every attention layer's k/v (or
        MLA latent) row at ``pos`` and every recurrent layer's state into
        ``cache`` in place and returns (logits [B, 1, V], cache). The token
        embed serves every modality, as in the reference."""
        h = params["embed"][batch["tokens"]].to(_dt(self.cfg.compute_dtype))
        steps = attn.decode_positions(h.shape[0], int(pos), h.device)
        for kind, si, s_lo, s_hi in self._seg_table():
            seg_cache = cache[str(si)]
            for i in range(s_hi - s_lo):
                lc = seg_cache if kind == "shared_attn" else layer_at(
                    seg_cache, i)
                h, _ = layer_decode(self._layers(params, kind, si, s_lo, i), h,
                                    lc, pos, self.cfg, kind, steps=steps)
        return self.head(params, h), cache


def token_loss(logits: torch.Tensor, batch: Dict, cfg) -> torch.Tensor:
    """Mean cross-entropy against batch['labels'] (labels < 0 masked); a
    VLM's logits are read at the text positions only."""
    labels = batch["labels"]
    lf = logits.float()
    if cfg.modality == "vision_stub" and lf.shape[1] != labels.shape[1]:
        lf = lf[:, lf.shape[1] - labels.shape[1]:]
    logz = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels.clamp(min=0)[..., None].long())[..., 0]
    mask = (labels >= 0).float()
    return torch.sum((logz - gold) * mask) / torch.clamp(mask.sum(), min=1.0)


def _chunk_loss(h_c: torch.Tensor, y_c: torch.Tensor, head_w: torch.Tensor):
    logits = (h_c @ head_w.to(h_c.dtype)).float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, y_c.clamp(min=0)[..., None].long())[..., 0]
    m = (y_c >= 0).float()
    return torch.sum((logz - gold) * m), torch.sum(m)


def chunked_ce_loss(h: torch.Tensor, head_w: torch.Tensor, batch: Dict, cfg,
                    *, chunk: int = 512) -> torch.Tensor:
    """Cross-entropy without holding [B, S, V] logits: sequence chunks, each
    checkpointed, so the backward recomputes one chunk's f32 logits at a
    time. head_w: [d, V]. Only the last ``labels.shape[1]`` positions of
    ``h`` are read: a VLM's image positions, in front, carry no label."""
    labels = batch["labels"]
    if h.shape[1] != labels.shape[1]:
        h = h[:, h.shape[1] - labels.shape[1]:]
    B, S, d = h.shape
    c = min(chunk, S)
    while S % c:
        c -= 1
    total = torch.zeros((), device=h.device)
    count = torch.zeros((), device=h.device)
    for i in range(0, S, c):
        l, m = ckpt.checkpoint(_chunk_loss, h[:, i:i + c], labels[:, i:i + c],
                               head_w, use_reentrant=False)
        total = total + l
        count = count + m
    return total / torch.clamp(count, min=1.0)


def build(cfg, device="cuda") -> LM:
    return LM(cfg, device)
