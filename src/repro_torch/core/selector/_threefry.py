"""The Gumbel stream of ``jax.random.gumbel(jax.random.PRNGKey(seed), (n,),
float32)``, reproduced in numpy so that the vectorized selector's
``epsilon > 0`` picks, and a resumed run's, follow the reference's draws.

With ``jax_threefry_partitionable`` on (JAX's default since 0.5), the
``(n,)`` draw of 32-bit words is Threefry-2x32 (20 rounds) keyed by the
64-bit seed's two halves, over the counters ``(i >> 32, i & 0xFFFFFFFF)``
for ``i = 0 .. n-1``, with the two output words XORed. ``uniform(minval=
tiny, maxval=1)`` keeps the top 23 bits as the mantissa of a float in
[1, 2), subtracts 1, and clamps at the smallest normal; the noise is
``-log(-log(u))`` (JAX's default "low" mode).

The words and the uniforms are computed on the host (uint32 arithmetic
wraps in numpy as in XLA); the two logarithms run in f32 on the caller's
device.
"""
from __future__ import annotations

import numpy as np
import torch

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_TINY = np.finfo(np.float32).tiny


def _rotl(x: np.ndarray, d: int) -> np.ndarray:
    return (x << np.uint32(d)) | (x >> np.uint32(32 - d))


def threefry2x32(k0: int, k1: int, x0: np.ndarray, x1: np.ndarray):
    """Threefry-2x32 with 20 rounds over uint32 counter pairs."""
    ks = (np.uint32(k0), np.uint32(k1),
          np.uint32((k0 ^ k1 ^ 0x1BD11BDA) & 0xFFFFFFFF))
    x0 = x0 + ks[0]
    x1 = x1 + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def random_bits(seed: int, n: int) -> np.ndarray:
    """[n] uint32: ``jax.random.bits(jax.random.PRNGKey(seed), (n,))``."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    i = np.arange(n, dtype=np.uint64)
    hi = (i >> np.uint64(32)).astype(np.uint32)
    lo = (i & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    b0, b1 = threefry2x32(seed >> 32, seed & 0xFFFFFFFF, hi, lo)
    return b0 ^ b1


def uniform_tiny(seed: int, n: int) -> np.ndarray:
    """[n] f32 in [tiny, 1): ``jax.random.uniform(key, (n,), float32,
    minval=tiny, maxval=1)``."""
    bits = (random_bits(seed, n) >> np.uint32(9)) | np.uint32(0x3F800000)
    floats = bits.view(np.float32) - np.float32(1.0)
    span = np.float32(1.0) - _TINY          # 1.0 in f32, as in the reference
    return np.maximum(_TINY, floats * span + _TINY)


def gumbel(seed: int, n: int, device) -> torch.Tensor:
    """[n] f32 Gumbel noise on ``device``: ``jax.random.gumbel(
    jax.random.PRNGKey(seed), (n,), jnp.float32)``."""
    u = torch.from_numpy(uniform_tiny(seed, n)).to(device)
    return -torch.log(-torch.log(u))
