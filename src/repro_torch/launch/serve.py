"""Batched decode serving driver (counterpart of ``repro/launch/serve.py``):
greedy decode over a preallocated KV cache, prefill-free.

Every request of the batch steps its prompt one token at a time through
``LM.decode_step``, then decodes greedily. On the card every GQA attention
(of a dense or a MoE layer) of every step runs the flash-decode kernel
(``kernels/csrc/decode_attention.cu``) over the whole cache with ``length
= pos + 1``; MLA (MiniCPM3, deepseek-v2) decodes matrix-absorbed over its
latent cache in plain einsums, as the reference does; a MoE layer's FFN
routes the batch as one token group at twice the capacity factor; a
hybrid model's Mamba2 layers and an xLSTM's mLSTM and sLSTM layers step
their O(1) recurrences, which need no kernel. The stub modalities decode
their prompt tokens through the token embed, as the reference does
(InternVL2 serves text; HuBERT, encoder-only, then decodes causally over
its cache). The generated tokens stay
on the device until the loop ends and cross to the host once; the clock
stops after ``torch.cuda.synchronize()``.

Examples (one H100, full width):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b --full
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-7b --full \\
      --batch 8 --prompt-len 192 --gen-len 64
  PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-350m \\
      --full --batch 8 --prompt-len 192 --gen-len 64
  PYTHONPATH=src python -m repro_torch.launch.serve --arch minicpm3-4b \\
      --full --batch 8 --prompt-len 192 --gen-len 64
  PYTHONPATH=src python -m repro_torch.launch.serve --arch internvl2-2b \\
      --full --batch 8 --prompt-len 192 --gen-len 64
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch._device import resolve_device
from repro_torch.models.transformer import build


def serve(arch: str, *, reduced: bool = True, batch: int = 4,
          prompt_len: int = 16, gen_len: int = 32, seed: int = 0,
          device="cuda") -> dict:
    """The reference's ``serve`` plus ``device``. Returns {"generated":
    int32 [batch, gen_len] numpy array, "tokens_per_s"}."""
    dev = resolve_device(device)
    cfg = configs.get(arch)
    if reduced:
        cfg = cfg.reduced()
    model = build(cfg, dev)
    with torch.inference_mode():
        params = model.init(torch.Generator(device=dev).manual_seed(seed))
        max_seq = prompt_len + gen_len
        cache = model.init_cache(batch=batch, max_seq=max_seq)

        rng = np.random.RandomState(seed)
        prompt = rng.randint(0, cfg.vocab_size,
                             (batch, prompt_len)).astype(np.int32)
        toks = torch.as_tensor(prompt, device=dev)
        gen = torch.empty((batch, gen_len), dtype=torch.int32, device=dev)

        # "prefill" by stepping the prompt (simple serving; batched requests
        # share the step), as the reference does
        t0 = time.time()
        logits = None
        for t in range(prompt_len):
            logits, cache = model.decode_step(
                params, {"tokens": toks[:, t:t + 1]}, cache, t)
        for t in range(prompt_len, max_seq):
            nxt = torch.argmax(logits[:, 0], dim=-1).to(torch.int32)
            gen[:, t - prompt_len] = nxt
            logits, cache = model.decode_step(
                params, {"tokens": nxt[:, None]}, cache, t)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.time() - t0
        gen = gen.cpu().numpy()
    tps = batch * gen_len / dt
    print(f"{arch}: generated {gen.shape} in {dt:.2f}s ({tps:.1f} tok/s)")
    return {"generated": gen, "tokens_per_s": tps}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen-len", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    serve(a.arch, reduced=a.reduced, batch=a.batch, prompt_len=a.prompt_len,
          gen_len=a.gen_len, device=a.device)


if __name__ == "__main__":
    main()
