"""GPS C/A (coarse/acquisition) Gold-code generation.

Functional equivalent of the reference's `generateCAcode.m` (G1: x^10+x^3+1,
G2: taps {2,3,6,8,9,10}, per-PRN circular G2 shift, ±1 chips) re-built as a
vectorized all-PRN table: the two 1023-chip m-sequences are generated once
and every PRN's code is a roll of G2 against G1, so the full (51, 1023)
codebook is a single numpy op — no per-PRN loops on the hot path.

Chip convention matches the reference: value -1 ↔ logical chip 0,
value +1 ↔ logical chip 1 is *not* assumed anywhere downstream; codes are
used as ±1 multipliers only.  (generateCAcode.m:64 emits -(g1.*g2).)
"""

from __future__ import annotations

import functools

import numpy as np

CODE_LENGTH = 1023

# Per-PRN G2 circular shift (chips).  PRNs 1..32 are GPS; 33..51 are the
# WAAS/EGNOS entries the reference also carries (generateCAcode.m:16-24).
G2_SHIFTS = (
    5, 6, 7, 8, 17, 18, 139, 140, 141, 251,
    252, 254, 255, 256, 257, 258, 469, 470, 471, 472,
    473, 474, 509, 512, 513, 514, 515, 516, 859, 860,
    861, 862,
    145, 175, 52, 21, 237, 235, 886, 657,
    634, 762, 355, 1012, 176, 603, 130, 359, 595, 68,
    386,
)
N_PRN = len(G2_SHIFTS)


def _msequence(taps: tuple) -> np.ndarray:
    """10-bit LFSR m-sequence, all-ones seed, output = stage 10.

    Returns ±1 chips with the reference's convention (register seeded with
    -1 i.e. logical one; feedback is the product of the tapped stages).
    """
    reg = -np.ones(10)
    out = np.empty(CODE_LENGTH)
    for i in range(CODE_LENGTH):
        out[i] = reg[9]
        fb = np.prod(reg[list(t - 1 for t in taps)])
        reg[1:] = reg[:-1]
        reg[0] = fb
    return out


@functools.lru_cache(maxsize=1)
def ca_code_table() -> np.ndarray:
    """(N_PRN, 1023) float32 table of ±1 C/A chips for PRN 1..N_PRN.

    Row p-1 is PRN p.  CAcode = -(G1 .* shifted G2) as in
    generateCAcode.m:61-64.
    """
    g1 = _msequence((3, 10))
    g2 = _msequence((2, 3, 6, 8, 9, 10))
    shifts = np.asarray(G2_SHIFTS)
    # g2_shifted[p] = concat(g2[1023-shift:], g2[:1023-shift]) == roll by +shift
    idx = (np.arange(CODE_LENGTH)[None, :] - shifts[:, None]) % CODE_LENGTH
    g2s = g2[idx]
    return (-(g1[None, :] * g2s)).astype(np.float32)


def ca_code(prn: int) -> np.ndarray:
    """±1 C/A chips (1023,) for a single PRN (1-based)."""
    if not 1 <= prn <= N_PRN:
        raise ValueError(f"PRN must be in 1..{N_PRN}, got {prn}")
    return ca_code_table()[prn - 1]


def ca_code_bits(prn: int) -> np.ndarray:
    """Logical chips {0,1}; +1 chip value ↔ logical 1 (IS-GPS-200 G1⊕G2)."""
    return ((ca_code(prn) + 1) // 2).astype(np.int8)
