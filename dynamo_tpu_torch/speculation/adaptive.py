"""Adaptive speculative-window control: the port's own copy of
`dynamo_tpu/speculation/adaptive.py` (it imports nothing of the JAX
package); keep the two in step.

A fixed K is wrong in both directions: a non-repeating stream burns
(K+1)x compute per emitted token at near-zero acceptance, while a
high-acceptance stream leaves tokens on the table. The controller sizes
the window per slot from the acceptance lengths the verify step already
produces. The verify step stays a fixed K+1-wide row (one captured graph
per sampling-gate tuple); a shrunken window drafts fewer real tokens and
pads the row, which changes draft-side work, never the output, since
`verify_accept` accepts only what the sequential chain draws.
"""

from __future__ import annotations

from typing import Dict


class AdaptiveK:
    """Per-slot speculative window size, bounded ``1 <= k <= k_max``.

    - a zero-accept window halves the slot's k;
    - `grow_streak` consecutive windows that accept the full current
      window grow k by one;
    - anything in between holds.
    """

    def __init__(self, k_max: int, grow_streak: int = 2):
        if k_max < 1:
            raise ValueError(f"k_max must be >= 1 (got {k_max})")
        self.k_max = k_max
        self.grow_streak = max(1, grow_streak)
        self._k: Dict[int, int] = {}
        self._streak: Dict[int, int] = {}

    def k(self, slot: int) -> int:
        """Current window for a slot (slots start at k_max)."""
        return self._k.get(slot, self.k_max)

    def update(self, slot: int, n_acc: int, k_used: int) -> None:
        """Feed one verify window's outcome: `n_acc` accepted of the
        `k_used` real drafts the slot proposed."""
        k = self.k(slot)
        if n_acc <= 0:
            self._k[slot] = max(1, k // 2)
            self._streak[slot] = 0
        elif n_acc >= k_used:
            streak = self._streak.get(slot, 0) + 1
            if streak >= self.grow_streak and k < self.k_max:
                self._k[slot] = k + 1
                self._streak[slot] = 0
            else:
                self._streak[slot] = streak
        else:
            self._streak[slot] = 0

    def reset(self, slot: int) -> None:
        """Slot teardown (finish, preempt, abort): the slot's next tenant
        starts at k_max."""
        self._k.pop(slot, None)
        self._streak.pop(slot, None)

    def snapshot(self) -> Dict[int, int]:
        """Per-slot windows for /worker/stats (only slots that moved)."""
        return dict(self._k)
