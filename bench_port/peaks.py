"""The card's peaks and the arithmetic of the kernels' bounds.

The issue bound of a CRUSH draw is copied from the port's chip smoke
test (`chip_smoke.py`: DRAW_OPS, HASH2_OPS, the issue rate): it counts
the integer operations of one straw2 draw as the sm_90 SASS issues them
(three-input IADD3 and LOP3, IMAD.WIDE for 32 x 32 -> 64 products, table
loads from shared memory), the divide as a multiply by a reciprocal, and
leaves out the rest of the rule (is_out's hash, collision checks, loop
control), so the bound lies below the least time.  The pipeline kernel
adds one placement-seed hash a PG.  The issue rate is every scheduler of
every SM issuing one warp instruction a clock at the card's maximum SM
clock.
"""

from __future__ import annotations

import functools
import subprocess

# NVIDIA's data sheet, SXM part: HBM bandwidth; SMs and the issue slots
# of each per clock (4 schedulers of one warp of 32 lanes)
CARDS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12, "sms": 132},
}
SCHEDULERS_PER_SM, WARP = 4, 32
DRAW_OPS = {
    "loads": 2,          # the weight with its reciprocal, the id
    "hash3": 2 + 5 * 9 * 3 + 1,  # seed^a^b^c; 5 mixes of 9 steps; & 0xffff
    "crush_ln": 19,      # normalise, two table rows, 64-bit arithmetic
    "numerator": 2,      # 2^48 - ln, 64-bit
    "divide": 7,         # high half of a 64-bit reciprocal product, shift
    "compare": 6,        # weight != 0; 64-bit compare; keep draw, index
}
OPS_PER_DRAW = sum(DRAW_OPS.values())
HASH2_OPS = 1 + 3 * 9 * 3  # the placement seed's hash32_2, a PG


def card(name: str) -> dict | None:
    return CARDS.get(name)


@functools.cache
def max_sm_clock_hz() -> float | None:
    """The card's maximum SM clock (nvidia-smi), or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, check=True, timeout=60)
        return float(out.stdout.strip().splitlines()[0]) * 1e6
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def issue_rate(name: str) -> float | None:
    """Lane operations a second: every scheduler of every SM issuing one
    instruction of 32 lanes a clock."""
    c, clock = card(name), max_sm_clock_hz()
    if c is None or clock is None:
        return None
    return c["sms"] * SCHEDULERS_PER_SM * WARP * clock


def pipeline_ops(draws: int, pgs: int) -> int:
    return draws * OPS_PER_DRAW + pgs * HASH2_OPS
