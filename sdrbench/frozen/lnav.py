"""GPS LNAV navigation-message encoder.

The exact inverse of the receiver's nav decoder (and of the reference's
`naviDecode_updated.m` bit maps): packs ephemeris fields into subframes
1-3 with IS-GPS-200 Hamming(32,26) parity, running D29*/D30* context, and
the solved non-information bits in words 2 and 10 that force the last two
parity bits of HOW/word-10 to zero (the `end_HOW` check,
naviDecode_updated.m:137-139).

Used by the synthetic IF generator so acquisition→tracking→decode→PVT can
be tested end-to-end without the real captures.  Bit positions cited below
are 1-based frame positions as read by naviDecode_updated.m:154-218.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

PREAMBLE_BITS = np.array([1, 0, 0, 0, 1, 0, 1, 1], dtype=np.int8)

# Parity tap columns (1-based data-bit indices) for p25..p30 — the H matrix
# of paritychk_James.m:26-31 / IS-GPS-200 Table 20-XIV.
PARITY_TAPS = (
    (1, 2, 3, 5, 6, 10, 11, 12, 13, 14, 17, 18, 20, 23),
    (2, 3, 4, 6, 7, 11, 12, 13, 14, 15, 18, 19, 21, 24),
    (1, 3, 4, 5, 7, 8, 12, 13, 14, 15, 16, 19, 20, 22),
    (2, 4, 5, 6, 8, 9, 13, 14, 15, 16, 17, 20, 21, 23),
    (1, 3, 5, 6, 7, 9, 10, 14, 15, 16, 17, 18, 21, 22, 24),
    (3, 5, 6, 8, 9, 10, 11, 13, 15, 19, 22, 23, 24),
)
# Which of (D29*, D30*) seeds each parity bit (paritychk_James.m:38).
PARITY_DSTAR = (0, 1, 0, 1, 1, 0)


def word_parity(data24: np.ndarray, d29: int, d30: int) -> np.ndarray:
    """Six parity bits for one word given source data bits and D29*/D30*."""
    p = np.empty(6, dtype=np.int8)
    for i, taps in enumerate(PARITY_TAPS):
        acc = d29 if PARITY_DSTAR[i] == 0 else d30
        for t in taps:
            acc ^= int(data24[t - 1])
        p[i] = acc
    return p


def encode_word(data24: np.ndarray, d29: int, d30: int,
                solve_tail: bool = False) -> np.ndarray:
    """30 transmitted bits: data XOR D30*, then parity.

    If `solve_tail`, data bits 23-24 are chosen so the transmitted parity
    bits 29-30 are zero (HOW and word 10 of every subframe).
    """
    data24 = np.array(data24, dtype=np.int8)
    if solve_tail:
        for b23 in (0, 1):
            for b24 in (0, 1):
                data24[22], data24[23] = b23, b24
                p = word_parity(data24, d29, d30)
                if p[4] == 0 and p[5] == 0:
                    break
            else:
                continue
            break
        else:  # pragma: no cover — always solvable (2 free bits, 2 equations)
            raise AssertionError("parity tail unsolvable")
        p = word_parity(data24, d29, d30)
    else:
        p = word_parity(data24, d29, d30)
    out = np.empty(30, dtype=np.int8)
    out[:24] = data24 ^ d30
    out[24:] = p
    return out


def _put(bits: np.ndarray, start_1b: int, width: int, value: int) -> None:
    """Write `value` MSB-first into frame bit positions [start, start+width)."""
    if value < 0 or value >= (1 << width):
        raise ValueError(f"field overflow: {value} in {width} bits")
    for k in range(width):
        bits[start_1b - 1 + k] = (value >> (width - 1 - k)) & 1


def _quant(value: float, lsb_pow2: int, width: int, signed: bool,
           scale: float = 1.0) -> int:
    """Quantize a physical value to the broadcast integer field."""
    q = int(round(value / scale / (2.0 ** lsb_pow2)))
    if signed:
        lo, hi = -(1 << (width - 1)), (1 << (width - 1)) - 1
        q = max(lo, min(hi, q))
        return q & ((1 << width) - 1)
    return max(0, min((1 << width) - 1, q))


def _split(q: int, msb_width: int, lsb_width: int):
    return (q >> lsb_width) & ((1 << msb_width) - 1), q & ((1 << lsb_width) - 1)


PI = 3.1415926535898  # GPS pi


def _wrap_semicircle(angle_rad: float) -> float:
    """Wrap an angle into [−π, π) — broadcast angles are signed
    semicircles; values outside the range must wrap, not clamp."""
    return (angle_rad + PI) % (2.0 * PI) - PI


def subframe_source_bits(sf_id: int, tow_s: float, eph: Dict[str, float],
                         weeknum: int) -> np.ndarray:
    """300 source bits (pre-parity, pre-inversion) for one subframe.

    `tow_s` is the GPS time of week at the *start* of this subframe; the
    HOW carries the z-count of the next subframe (decoder: (z−1)·6 = tow,
    naviDecode_updated.m:154).
    """
    b = np.zeros(300, dtype=np.int8)
    b[0:8] = PREAMBLE_BITS                       # TLM preamble, bits 1-8
    z_count = int(round(tow_s / 6.0)) + 1
    _put(b, 31, 17, z_count & 0x1FFFF)           # HOW TOW, bits 31-47
    _put(b, 50, 3, sf_id)                        # subframe ID, bits 50-52

    if sf_id == 1:
        _put(b, 61, 10, (weeknum - 2048) % 1024)             # bits 61-70
        _put(b, 73, 4, int(eph.get("ura", 0)))               # URA index
        _put(b, 77, 6, int(eph.get("health", 0)))            # bits 77-82
        iodc = int(eph.get("iodc", 0))
        _put(b, 83, 2, (iodc >> 8) & 0x3)
        _put(b, 197, 8, _quant(eph["tgd"], -31, 8, True))
        _put(b, 211, 8, iodc & 0xFF)
        _put(b, 219, 16, _quant(eph["toc"], 4, 16, False))
        _put(b, 241, 8, _quant(eph["af2"], -55, 8, True))
        _put(b, 249, 16, _quant(eph["af1"], -43, 16, True))
        _put(b, 271, 22, _quant(eph["af0"], -31, 22, True))
    elif sf_id == 2:
        _put(b, 61, 8, int(eph.get("iode", 0)))
        _put(b, 69, 16, _quant(eph["crs"], -5, 16, True))
        _put(b, 91, 16, _quant(eph["deltan"], -43, 16, True, PI))
        m0 = _quant(_wrap_semicircle(eph["m0"]), -31, 32, True, PI)
        msb, lsb = _split(m0, 8, 24)
        _put(b, 107, 8, msb); _put(b, 121, 24, lsb)
        _put(b, 151, 16, _quant(eph["cuc"], -29, 16, True))
        ecc = _quant(eph["ecc"], -33, 32, False)
        msb, lsb = _split(ecc, 8, 24)
        _put(b, 167, 8, msb); _put(b, 181, 24, lsb)
        _put(b, 211, 16, _quant(eph["cus"], -29, 16, True))
        sqa = _quant(eph["sqrta"], -19, 32, False)
        msb, lsb = _split(sqa, 8, 24)
        _put(b, 227, 8, msb); _put(b, 241, 24, lsb)
        _put(b, 271, 16, _quant(eph["toe"], 4, 16, False))
    elif sf_id == 3:
        _put(b, 61, 16, _quant(eph["cic"], -29, 16, True))
        om0 = _quant(_wrap_semicircle(eph["omega0"]), -31, 32, True, PI)
        msb, lsb = _split(om0, 8, 24)
        _put(b, 77, 8, msb); _put(b, 91, 24, lsb)
        _put(b, 121, 16, _quant(eph["cis"], -29, 16, True))
        i0 = _quant(eph["i0"], -31, 32, True, PI)
        msb, lsb = _split(i0, 8, 24)
        _put(b, 137, 8, msb); _put(b, 151, 24, lsb)
        _put(b, 181, 16, _quant(eph["crc"], -5, 16, True))
        w = _quant(_wrap_semicircle(eph["w"]), -31, 32, True, PI)
        msb, lsb = _split(w, 8, 24)
        _put(b, 197, 8, msb); _put(b, 211, 24, lsb)
        _put(b, 241, 24, _quant(eph["omegadot"], -43, 24, True, PI))
        _put(b, 271, 8, int(eph.get("iode", 0)))
        _put(b, 279, 14, _quant(eph["idot"], -43, 14, True, PI))
    elif sf_id in (4, 5):
        # subframes 4/5 carry almanac pages — real pages have dense,
        # page-varying data.  Zero-filled data words are degenerate:
        # with a steady D30* the transmitted word repeats, producing
        # 50-bit constant stretches with NO bit edges — anything that
        # needs transitions in that second (bit sync, the countinx
        # search, trackingCT.m:178-213) starves.  Fill words 3-10 with
        # a deterministic per-(tow, subframe) pseudo-pattern instead;
        # the decoder only checks parity and the subframe ID here
        # (naviDecode_updated.m:220-223).
        rng = np.random.default_rng(int(round(tow_s)) * 5 + sf_id)
        b[60:300] = rng.integers(0, 2, size=240).astype(np.int8)
    return b


def encode_frames(eph: Dict[str, float], weeknum: int, tow_start_s: float,
                  n_subframes: int) -> np.ndarray:
    """Transmitted bit stream for `n_subframes` consecutive subframes.

    Starts at subframe ID ((tow_start/6) mod 5)+1 so the stream is
    consistent with GPS time; runs the D29*/D30* parity context across
    word and subframe boundaries.  Returns {0,1} bits.
    """
    if tow_start_s % 6 != 0:
        raise ValueError("tow_start_s must be a subframe boundary (mult. of 6)")
    out = np.empty(n_subframes * 300, dtype=np.int8)
    d29, d30 = 0, 0
    for k in range(n_subframes):
        tow = tow_start_s + 6.0 * k
        sf_id = int(tow / 6.0) % 5 + 1
        src = subframe_source_bits(sf_id, tow, eph, weeknum)
        for w in range(10):
            solve = w in (1, 9)  # HOW and word 10 carry solved tail bits
            word = encode_word(src[w * 30: w * 30 + 24], d29, d30,
                               solve_tail=solve)
            out[k * 300 + w * 30: k * 300 + (w + 1) * 30] = word
            d29, d30 = int(word[28]), int(word[29])
    return out
