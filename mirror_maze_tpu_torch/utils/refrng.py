"""rand-0.8-compatible RNG: ChaCha12 core + StdRng draw semantics.

The reference builds its world from Rust's `rand 0.8.5` `StdRng` seeded
with `seed_from_u64(0)` (`main.rs:381`): one stream
drives the Kruskal edge shuffle (`main.rs:382`), then the per-wall
mirror rolls (`main.rs:460-464, 494-498`) and light-panel rolls
(`main.rs:466-480, 501-514`). Reproducing the reference's literal
seed-0 world therefore requires reproducing that stream bit-for-bit:

- rand 0.8's ``StdRng`` is ``rand_chacha::ChaCha12Rng`` — the original
  (djb) ChaCha variant with a 64-bit block counter (state words 12-13)
  and 64-bit stream id (words 14-15, zero here), 12 rounds.
- ``SeedableRng::seed_from_u64`` (rand_core 0.6) expands the u64 to the
  32-byte ChaCha key through a PCG32 step per 4 bytes (advance first,
  then XSH-RR output, little-endian bytes).
- ``Rng::gen::<f32>()`` takes the TOP 24 bits of ``next_u32`` and
  scales by 2^-24 (rand 0.8 `Standard` for f32: multiply-based,
  [0, 1), 24 random bits).
- ``SliceRandom::shuffle`` is a Fisher-Yates sweep from the end;
  each index draws ``gen_range(0..i+1 as u32)`` = rand 0.8
  ``UniformInt::<u32>::sample_single``: Lemire widening-multiply with
  conservative zone ``(range << range.leading_zeros()) - 1``,
  rejecting while the low product word exceeds the zone.

Pure Python integers — this runs once at scene build time (a few
hundred u32 draws); no JAX/NumPy needed. Validated against published
vectors in tests/test_refrng.py: the RFC 8439 quarter-round and
ChaCha20 zero-key keystream, the draft-strombergson ChaCha12 TC1
vector, and rand's own StdRng value-stability target.
"""

from __future__ import annotations

from typing import List, MutableSequence

_MASK32 = 0xFFFFFFFF
# "expand 32-byte k" as little-endian u32 words.
_SIGMA = (0x61707865, 0x3320646E, 0x79622D32, 0x6B206574)


def _rotl32(x: int, n: int) -> int:
    return ((x << n) | (x >> (32 - n))) & _MASK32


def _quarter_round(s: List[int], a: int, b: int, c: int, d: int) -> None:
    s[a] = (s[a] + s[b]) & _MASK32
    s[d] = _rotl32(s[d] ^ s[a], 16)
    s[c] = (s[c] + s[d]) & _MASK32
    s[b] = _rotl32(s[b] ^ s[c], 12)
    s[a] = (s[a] + s[b]) & _MASK32
    s[d] = _rotl32(s[d] ^ s[a], 8)
    s[c] = (s[c] + s[d]) & _MASK32
    s[b] = _rotl32(s[b] ^ s[c], 7)


def chacha_block(state: List[int], rounds: int) -> List[int]:
    """One ChaCha block: `rounds` rounds over a 16-word state, then the
    feed-forward add. Returns the 16 keystream words (consume as LE u32)."""
    w = list(state)
    for _ in range(rounds // 2):
        _quarter_round(w, 0, 4, 8, 12)
        _quarter_round(w, 1, 5, 9, 13)
        _quarter_round(w, 2, 6, 10, 14)
        _quarter_round(w, 3, 7, 11, 15)
        _quarter_round(w, 0, 5, 10, 15)
        _quarter_round(w, 1, 6, 11, 12)
        _quarter_round(w, 2, 7, 8, 13)
        _quarter_round(w, 3, 4, 9, 14)
    return [(w[i] + state[i]) & _MASK32 for i in range(16)]


class ChaChaRng:
    """ChaCha keystream as a u32 source, rand_chacha layout.

    djb variant: words 0-3 sigma, 4-11 key (LE from the 32-byte seed),
    12-13 the 64-bit block counter (starts 0), 14-15 the stream id
    (rand_chacha's from_seed leaves it 0). Words are consumed in block
    order z0..z15, blocks in counter order — rand_chacha buffers 4
    blocks at a time but emits them sequentially, so a serial block
    walk produces the identical stream.
    """

    def __init__(self, seed: bytes, rounds: int = 12):
        if len(seed) != 32:
            raise ValueError(f"seed must be 32 bytes (got {len(seed)})")
        self._key = [int.from_bytes(seed[4 * i:4 * i + 4], "little")
                     for i in range(8)]
        self._rounds = rounds
        self._counter = 0
        self._buf: List[int] = []
        self._pos = 0

    def _refill(self) -> None:
        state = [
            *_SIGMA,
            *self._key,
            self._counter & _MASK32,
            (self._counter >> 32) & _MASK32,
            0,
            0,
        ]
        self._buf = chacha_block(state, self._rounds)
        self._counter += 1
        self._pos = 0

    def next_u32(self) -> int:
        if self._pos >= len(self._buf):
            self._refill()
        v = self._buf[self._pos]
        self._pos += 1
        return v


def seed_from_u64(state: int) -> bytes:
    """rand_core 0.6 ``SeedableRng::seed_from_u64``: expand a u64 into a
    32-byte seed via PCG32 (advance-then-output XSH-RR, LE bytes)."""
    mul = 6364136223846793005
    inc = 11634580027462260723
    state &= (1 << 64) - 1
    out = bytearray()
    for _ in range(8):
        state = (state * mul + inc) & ((1 << 64) - 1)
        xorshifted = (((state >> 18) ^ state) >> 27) & _MASK32
        rot = state >> 59
        x = ((xorshifted >> rot) | (xorshifted << ((32 - rot) & 31))) & _MASK32
        out += x.to_bytes(4, "little")
    return bytes(out)


class StdRng08:
    """rand 0.8 ``StdRng`` (= ChaCha12Rng) with the draw semantics the
    reference consumes: gen::<f32>(), gen_range(0..n as u32), shuffle."""

    def __init__(self, seed: bytes):
        self._core = ChaChaRng(seed, rounds=12)

    @classmethod
    def seed_from_u64(cls, n: int) -> "StdRng08":
        return cls(seed_from_u64(n))

    def next_u32(self) -> int:
        return self._core.next_u32()

    def next_u64(self) -> int:
        # rand_core BlockRng: low word first, then high.
        lo = self.next_u32()
        hi = self.next_u32()
        return lo | (hi << 32)

    def gen_f32(self) -> float:
        """``Rng::gen::<f32>()``: top 24 bits scaled into [0, 1).
        The result is exact in f32 (24-bit int times a power of two), so
        returning a Python float keeps comparisons bit-faithful."""
        return (self.next_u32() >> 8) * (1.0 / 16777216.0)

    def gen_range_u32(self, ubound: int) -> int:
        """``gen_range(0..ubound)`` for u32: rand 0.8
        ``UniformInt::sample_single`` — Lemire widening multiply with the
        conservative zone, looping on rejection."""
        if not 0 < ubound <= 1 << 32:
            raise ValueError(f"ubound out of u32 range: {ubound}")
        rng_range = ubound & _MASK32  # ubound == 2^32 wraps to 0 (full range)
        if rng_range == 0:
            return self.next_u32()
        lz = 32 - rng_range.bit_length()
        zone = ((rng_range << lz) - 1) & _MASK32
        while True:
            v = self.next_u32()
            m = v * rng_range
            hi, lo = m >> 32, m & _MASK32
            if lo <= zone:
                return hi

    def shuffle(self, seq: MutableSequence) -> None:
        """``SliceRandom::shuffle``: Fisher-Yates from the back; each i
        draws gen_index(i+1) = gen_range(0..i+1 as u32)."""
        for i in range(len(seq) - 1, 0, -1):
            j = self.gen_range_u32(i + 1)
            seq[i], seq[j] = seq[j], seq[i]
