"""What a driver keeps of the window's outputs for the check."""

from __future__ import annotations

import collections

import numpy as np


class Kept:
    """A uniform sample of `k` of the window's outputs, drawn from the
    seed (reservoir sampling: the window's length is not known ahead),
    and its last `last` outputs.  Items are (op index, output)."""

    def __init__(self, k: int, last: int, seed: int):
        self.k = k
        self.rng = np.random.default_rng([seed, 0x6B657074])
        self.sample: list = []
        self.tail = collections.deque(maxlen=last)
        self.seen = 0

    def add(self, i: int, out) -> None:
        self.tail.append((i, out))
        if len(self.sample) < self.k:
            self.sample.append((i, out))
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.k:
                self.sample[j] = (i, out)
        self.seen += 1

    def items(self) -> list:
        """Every kept output once, in op order."""
        out = {i: o for i, o in list(self.sample) + list(self.tail)}
        return sorted(out.items(), key=lambda kv: kv[0])
