"""Re-entrant glibc-compatible RNG (bit-reproducible shuffles).

The reference embeds a copy of glibc 2.23's random_r (TYPE_3: degree-31
trinomial x^31 + x^3 + 1 additive feedback, 128-byte state) so stepwise
starting trees are identical across platforms (reference: libpll-2
src/random.c:90-416). Carried over from libpll2_tpu/utils/rng.py so that
the port imports no jax; the stepwise tip order depends on it bit for bit.
"""
from __future__ import annotations

from typing import List

RAND_MAX = 2147483647
_DEG = 31      # TYPE_3 degree
_SEP = 3       # TYPE_3 separation


def _int32(x: int) -> int:
    x &= 0xFFFFFFFF
    return x - 0x100000000 if x >= 0x80000000 else x


class GlibcRandom:
    """random_r/srandom_r TYPE_3 clone."""

    def __init__(self, seed: int):
        seed = seed & 0xFFFFFFFF
        if seed == 0:
            seed = 1
        r: List[int] = [0] * _DEG
        r[0] = _int32(seed)
        # Schrage's method for 16807 * r % 2147483647 without overflow.
        # glibc computes hi/lo with C TRUNCATING division on a signed
        # int32 (negative for seeds >= 2^31) — floor division diverges.
        for i in range(1, _DEG):
            w = r[i - 1]
            hi = -((-w) // 127773) if w < 0 else w // 127773
            lo = w - hi * 127773
            word = 16807 * lo - 2836 * hi
            if word < 0:
                word += 2147483647
            r[i] = word
        self._r = r
        self._f = _SEP
        self._p = 0
        for _ in range(_DEG * 10):
            self.next()

    def next(self) -> int:
        """One 31-bit output."""
        r = self._r
        val = _int32(r[self._f] + r[self._p])
        r[self._f] = val
        result = (val & 0xFFFFFFFF) >> 1
        self._f = (self._f + 1) % _DEG
        self._p = (self._p + 1) % _DEG
        return result

    def getint(self, maxval: int) -> int:
        """0 <= r < maxval (pll_random_getint, random.c:407-413)."""
        return self.next() % maxval


def create_shuffled(n: int, seed: int) -> List[int]:
    """The reference's Fisher-Yates shuffle (stepwise.c:49-99); seed == 0
    returns the identity permutation."""
    x = list(range(n))
    if not seed:
        return x
    rng = GlibcRandom(seed)
    i = n - 1
    while n > 1:
        r = rng.next() / RAND_MAX
        j = int(r * (i + 1))
        x[i], x[j] = x[j], x[i]
        if i == 0:
            break
        i -= 1
    return x
