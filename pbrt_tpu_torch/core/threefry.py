"""Counter-based random numbers of the metropolis renderer.

The port's copy of what `jax.random` computes for the JAX package's
metropolis renderer and its stratified and Latin-hypercube patterns, in
the threefry2x32 implementation with `jax_threefry_partitionable = True`
(the default of JAX 0.5 and later): `prng_key`, `split`, `fold_in`,
32-bit `bits32`, float32 `uniform`, `choice` with probabilities and
`permutation`. The draws are bit-identical to `jax.random`'s.

A key is a pair of Python ints (two uint32 words); keys are derived on
the host, and only the bulk draws (`bits32`, `uniform`, `choice`,
`permutation`) run on the given device. uint32 arithmetic is carried in
int64 tensors (or Python ints) masked to 32 bits after every step, as in
core/sampling.py.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
SCAN_BLOCK = 16   # XLA's CPU cumulative sum: 16-element blocks, recursively

Key = Tuple[int, int]


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 block (20 rounds) of counters (x1, x2) under the
    key (k1, k2). Works on Python ints and on int64 tensors alike."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    a = (x1 + ks[0]) & M32
    b = (x2 + ks[1]) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            a = (a + b) & M32
            b = (((b << r) | (b >> (32 - r))) & M32) ^ a
        a = (a + ks[(i + 1) % 3]) & M32
        b = (b + ks[(i + 2) % 3] + i + 1) & M32
    return a, b


def prng_key(seed: int) -> Key:
    """jax.random.PRNGKey(seed) for a 32-bit seed: the high word is the
    seed shifted right by 32 bits (0), the low word the seed."""
    return (0, int(seed) & M32)


def split(key: Key, n: int = 2) -> list:
    """jax.random.split(key, n): the block of counters (0, i)."""
    return [threefry2x32(key[0], key[1], 0, i) for i in range(n)]


def fold_in(key: Key, data: int) -> Key:
    """jax.random.fold_in(key, data): the block of the counters
    (0, data), the seed words of `data`."""
    return threefry2x32(key[0], key[1], 0, int(data) & M32)


def bits32(key: Key, shape, device) -> torch.Tensor:
    """jax.random.bits(key, shape) for 32 bits, as int64 holding uint32:
    each element's bits are the two words of the block of the counters
    (flat index >> 32, flat index & M32), xored."""
    idx = torch.arange(math.prod(shape), dtype=torch.int64, device=device)
    a, b = threefry2x32(key[0], key[1], idx >> 32, idx & M32)
    return (a ^ b).reshape(tuple(shape))


def uniform(key: Key, shape, device) -> torch.Tensor:
    """jax.random.uniform(key, shape) in float32, in [0, 1): the top 23
    of each element's 32 bits (bits32) make the mantissa of a float in
    [1, 2), minus 1."""
    f = ((bits32(key, shape, device) >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return torch.clamp(f - 1.0, min=0.0)


def permutation(key: Key, n: int, device) -> torch.Tensor:
    """jax.random.permutation(key, n): arange(n) shuffled by rounds of a
    stable sort keyed by fresh 32-bit draws (each round splits the key
    and draws from the second half), ceil(3 ln n / ln(2^32 - 1)) rounds,
    as jax.random's _shuffle. -> int64 [n]."""
    x = torch.arange(n, dtype=torch.int64, device=device)
    for _ in range(math.ceil(3 * math.log(max(1, n)) / math.log(M32))):
        key, sub = split(key)
        x = x[torch.sort(bits32(sub, (n,), device), stable=True).indices]
    return x


def cumsum_f32(x: torch.Tensor) -> torch.Tensor:
    """The float32 running sum of x [n] in XLA's CPU order: blocks of
    SCAN_BLOCK summed left to right, each block offset by the running
    sum of the block totals before it (the same scheme, recursively).
    torch.cumsum accumulates in another order on each device."""
    n = x.shape[0]
    m = -(-n // SCAN_BLOCK)
    xb = torch.zeros(m * SCAN_BLOCK, dtype=torch.float32, device=x.device)
    xb[:n] = x
    xb = xb.reshape(m, SCAN_BLOCK)
    cols = [xb[:, 0]]
    for k in range(1, SCAN_BLOCK):
        cols.append(cols[-1] + xb[:, k])
    within = torch.stack(cols, 1)
    if m == 1:
        return within.reshape(-1)[:n]
    pre = cumsum_f32(within[:, -1].contiguous())
    excl = torch.cat([torch.zeros(1, device=x.device), pre[:-1]])
    return (within + excl[:, None]).reshape(-1)[:n]


def choice(key: Key, n: int, shape, p: torch.Tensor) -> torch.Tensor:
    """jax.random.choice(key, n, shape, p=p) with replacement: the left
    search of r = cdf[-1] * (1 - uniform) in the float32 running sum of
    p (cumsum_f32), on p's device. -> int64 indices."""
    if p.shape != (n,):
        raise ValueError(f"p must have shape ({n},), got {tuple(p.shape)}")
    cdf = cumsum_f32(p.to(torch.float32))
    r = cdf[-1] * (1.0 - uniform(key, shape, p.device))
    return torch.searchsorted(cdf, r.reshape(-1)).reshape(tuple(shape))
