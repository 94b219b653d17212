"""Random number management over ``torch.Generator``.

Counterpart of ``deeplearning4j_tpu/runtime/rng.py``. A network owns one
:class:`RngManager`, seeded from its configuration seed, which hands out
fresh ``torch.Generator``s. Its stream position is a two-word key, the same
shape as the JAX package's ``uint32[2]`` key, advanced by a split on every
draw, so ``get_state``/``set_state`` round-trip an archive's
``rng_seed``/``rng_key`` metadata in either direction. The two packages
draw different numbers from the same key; weights cross through archives,
never through seeds.

On a CUDA device a fit draws its masks from one generator on the card per
network (:func:`device_generator` returns it as it is), seeded at the start
of each fit from the network's key (:meth:`RngManager.peek_seed`). A
captured CUDA graph registers it, so every replay advances its Philox
offset and draws fresh masks, and a K-step graph consumes the stream as K
eager steps do: the masks do not depend on how the steps are grouped.
"""

from __future__ import annotations

import threading
from typing import List, Optional

import torch

_MASK64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def _key_from_seed(seed: int) -> List[int]:
    """``[hi, lo]`` words of the seed, as ``jax.random.PRNGKey`` lays it out."""
    s = int(seed) & _MASK64
    return [s >> 32, s & 0xFFFFFFFF]


def _key_int(key: List[int]) -> int:
    return ((int(key[0]) & 0xFFFFFFFF) << 32) | (int(key[1]) & 0xFFFFFFFF)


def generator_for(seed: int, *path: int) -> torch.Generator:
    """A CPU generator for ``seed`` and a fold-in path (e.g. a layer index):
    deterministic and independent of the device the draws end up on."""
    x = int(seed) & _MASK64
    for p in path:
        x = _splitmix64(x ^ _splitmix64(int(p) + 1))
    return torch.Generator(device="cpu").manual_seed(_splitmix64(x) & ((1 << 63) - 1))


class RngManager:
    """Owns a root key; :meth:`next_generator` splits it deterministically."""

    def __init__(self, seed: int = 0):
        self._seed = int(seed)
        self._key: Optional[List[int]] = None  # None: at the seed's origin
        self._lock = threading.Lock()  # guards: _key, _seed

    @property
    def seed(self) -> int:
        return self._seed

    def next_generator(self) -> torch.Generator:
        """A fresh CPU ``torch.Generator``; advances the stream."""
        with self._lock:
            key = self._key if self._key is not None else _key_from_seed(self._seed)
            k = _key_int(key)
            nxt = _splitmix64(k ^ 0x5851F42D4C957F2D)
            sub = _splitmix64(k ^ 0x14057B7EF767814F)
            self._key = [nxt >> 32, nxt & 0xFFFFFFFF]
        return torch.Generator(device="cpu").manual_seed(sub & ((1 << 63) - 1))

    def peek_seed(self) -> int:
        """A 63-bit seed folded from the current key, without advancing the
        stream (the seed of a fit's device generator)."""
        with self._lock:
            key = self._key if self._key is not None else _key_from_seed(self._seed)
            return _splitmix64(_key_int(key) ^ 0x2545F4914F6CDD1D) & ((1 << 63) - 1)

    def get_state(self) -> dict:
        """JSON-serializable stream position: the seed and the current key
        (``None`` while the stream is at its origin)."""
        with self._lock:
            return {"seed": self._seed,
                    "key": None if self._key is None else list(self._key)}

    def set_state(self, state: dict) -> None:
        with self._lock:
            self._seed = int(state["seed"])
            k = state.get("key")
            if k is None:
                self._key = None
                return
            k = [int(v) for v in k]
            if len(k) != 2:
                raise ValueError(f"rng key must have two words, got {len(k)}")
            self._key = k


def device_generator(generator: torch.Generator, device) -> torch.Generator:
    """The generator to draw on ``device`` with: ``generator`` itself when it
    already lives on that CUDA device (a fit's graph-safe stream), else a
    fresh generator there seeded by one draw from ``generator`` (the step's
    CPU generator)."""
    device = torch.device(device)
    if generator.device.type == "cuda" and device.type == "cuda" and (
            torch.device(generator.device).index or 0) == (device.index or 0):
        return generator
    seed = int(torch.randint(0, 2 ** 62, (), generator=generator))
    return torch.Generator(device=device).manual_seed(seed)
