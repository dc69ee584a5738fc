"""What the CUDA kernels' design rests on, held on the CPU at small sizes.

The kernels (gps_sdr_tpu_torch/csrc/) run only on a card; their arithmetic
is that of the plain versions, but which thread sums which sample differs:
a thread-block cluster per channel in track_chunk.cu, parts per channel in
corr_bank.cu, 16-byte runs of samples per thread in both.  Four properties
make that free, and each is held here:

(a) the order is free: the float32 terms of `correlate_blocks`, summed in
    float64 the way the kernels sum them (a thread's runs, the warp's
    shuffle tree, the warps in order, the ranks or parts in order), round to
    the float32 that `correlate_blocks` returns, bit for bit;
(b) converting the mixed sample to float64 once and multiplying by the chip
    equals converting the float32 product, for a ±1 table;
(c) the chip index kept along a run of samples (one mod per run, a bias, a
    correction where it leaves [0, 1023)) is the exact Q32 index;
(d) the share geometry (cluster size, split, rows per rank or part, tiles
    with an origin rounded down to 16 bytes, what is staged ahead with a
    margin and topped up) covers every sample of a block exactly once.

And (e): the prepared launches (`BankPlan`, `WindowsPlan`) are the plain
versions on the CPU and refuse what the checked entries refuse; with (c),
the code table that is made once per track is the table every CTA used to
make per launch; with (d), the threads a CTA is given fit the kernel
instance that its tap count is launched on.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from gps_sdr_tpu_torch.ops import corr_bank as cb
from gps_sdr_tpu_torch.ops import track_chunk as tc
from gps_sdr_tpu_torch.ops.cacode import CODE_LENGTH

torch.set_num_threads(2)

FS = 4.092e6


def threads_for(ntaps):
    """Threads of a correlator CTA compiled for `ntaps` taps, 0: the tap
    count read at run time (`threads_for` in csrc/nco_common.cuh)."""
    return 512 if 0 < ntaps <= 4 else 256


TAPS = {3: (-0.5, 0.0, 0.5),
        25: tuple(np.linspace(-1.2, 1.2, 25))}


# ------------------------------------------------------------ (a) the order

def _block(ntaps, seed):
    """Two channels' 1 ms blocks at 4.092 MHz: int8 IQ, noise of std 8 and a
    carrier of amplitude 4 with a DC offset, at arbitrary window offsets."""
    rng = np.random.default_rng(seed)
    n, blk = 2, 4352
    L = 3 * blk
    t = np.arange(L)
    sig = 4.0 * np.exp(2j * np.pi * (1.023e6 + 1500.0) / FS * t)
    x = np.stack([sig.real, sig.imag], 1) + rng.normal(0, 8.0, (L, 2)) + 1.7
    raw = torch.from_numpy(np.clip(np.round(x), -127, 127).astype(np.int8))
    chips = torch.from_numpy(
        rng.choice([-1.0, 1.0], (n, CODE_LENGTH)).astype(np.float32))
    i64, f64 = torch.int64, torch.float64
    rem = torch.tensor(rng.uniform(-0.4, 1.4, n), dtype=f64)
    code_freq = torch.tensor(1.023e6 * (1 + rng.uniform(-3e3, 3e3, n)
                                        / 1575.42e6), dtype=f64)
    step = code_freq / torch.tensor(FS, dtype=f64)
    num = torch.ceil((1023.0 - rem) / step).to(i64)
    return dict(
        raw=raw, blk=blk, chips=chips, rem=rem, step=step, num=num,
        off=torch.tensor(rng.integers(0, blk, n), dtype=i64),
        phase=torch.tensor(rng.integers(-2 ** 31, 2 ** 31, n), dtype=i64),
        carr_fp=torch.round(torch.tensor(
            1.023e6 + rng.uniform(-4e3, 4e3, n), dtype=f64) / FS * tc.Q32
        ).to(i64),
        tap_fp=cb.tap_offsets_fp(TAPS[ntaps], "cpu"))


def _terms(b, remove_dc):
    """The float32 terms that `correlate_blocks` sums: code (N, T, blk) and
    iq (N, blk, 2), by its own operations in its own order."""
    f32, f64 = torch.float32, torch.float64
    grid = tc.BlockGrid.make(b["blk"], "cpu")
    x_all = b["raw"].to(f32)
    n = b["off"].shape[0]
    blk = b["blk"]
    carr_fp = tc._wrap32(b["carr_fp"])
    idx = torch.clamp(b["off"][:, None] + grid.k[None, :], 0,
                      x_all.shape[0] - 1)
    mask = (grid.k[None, :] < b["num"][:, None])[..., None]
    x = torch.where(mask, x_all[idx], 0.0)
    if remove_dc:
        dc = (x.sum(dim=1, dtype=f64) / b["num"].to(f64)[:, None]).to(f32)
        x = torch.where(mask, x - dc[:, None, :], 0.0)
    phq = tc._wrap32(b["phase"][:, None] + grid.q[None, :]
                     * (carr_fp[:, None] * 128)).to(f32) * grid.to_rad
    phr = tc._wrap32(grid.r[None, :] * carr_fp[:, None]).to(f32) * grid.to_rad
    uc, us = torch.cos(phq), torch.sin(phq)
    vc, vs = torch.cos(phr), torch.sin(phr)
    c = (uc[:, :, None] * vc[:, None, :]
         - us[:, :, None] * vs[:, None, :]).reshape(n, blk)
    s = (uc[:, :, None] * vs[:, None, :]
         + us[:, :, None] * vc[:, None, :]).reshape(n, blk)
    xr, xi = x[..., 0], x[..., 1]
    iq = torch.stack([xr * s + xi * c, xr * c - xi * s], dim=-1)
    step_fp = torch.round(b["step"] * tc.Q32).to(torch.int64)
    base_fp = torch.round(b["rem"] * tc.Q32).to(torch.int64)
    cidx = torch.bitwise_right_shift(
        (base_fp[:, None] + b["tap_fp"][None, :] - 1)[:, :, None]
        + grid.k[None, None, :] * step_fp[:, None, None], 32)
    cidx = torch.remainder(cidx, CODE_LENGTH)
    code = torch.gather(b["chips"], 1, cidx.reshape(n, -1)).reshape(cidx.shape)
    return code, iq, grid


def _cta_sum(terms, lo, hi, origin, threads=None):
    """Float64 sum of terms[..., lo:hi] in a CTA's order.  A thread takes
    runs of 8 samples that start `origin` samples before `lo` (the tile's
    16-byte boundary), run g going to thread g mod `threads` (default
    `threads_for`), and adds them in sample order; a warp adds its threads
    by the xor-shuffle tree; the warps are added in order.  terms:
    (T, 2, blk) float64."""
    lead = terms.shape[:-1]
    if threads is None:
        threads = threads_for(terms.shape[0])
    if hi <= lo:
        return np.zeros(lead)
    k0 = lo - origin
    n_runs = -(-(hi - k0) // 8)
    rounds = -(-n_runs // threads)
    padded = np.zeros(lead + (rounds * threads * 8,))
    ks = np.arange(k0, k0 + padded.shape[-1])
    ok = (ks >= lo) & (ks < hi)
    padded[..., ok] = terms[..., ks[ok]]
    runs = padded.reshape(lead + (rounds, threads, 8))
    acc = np.zeros(lead + (threads,))
    for r in range(rounds):
        for j in range(8):
            acc = acc + runs[..., r, :, j]
    lanes = acc.reshape(lead + (threads // 32, 32))
    for o in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[..., np.arange(32) ^ o]
    total = np.zeros(lead)
    for w in range(threads // 32):
        total = total + lanes[..., w, 0]
    return total


def _products(b, remove_dc):
    code, iq, grid = _terms(b, remove_dc)
    want = tc.correlate_blocks(
        b["raw"].to(torch.float32), b["off"], b["num"], b["rem"], b["step"],
        tc._wrap32(b["phase"]), tc._wrap32(b["carr_fp"]), b["chips"],
        b["tap_fp"], remove_dc, grid)
    # (N, T, 2, blk): exact in float64 (a float32 chip times a float32 sample)
    prod = (code.to(torch.float64)[:, :, None, :]
            * iq.to(torch.float64).permute(0, 2, 1)[:, None, :, :]).numpy()
    return prod, want.numpy()


def _magnitudes(prod, want):
    return (f"largest term {np.abs(prod).max():.3g}, correlators up to "
            f"{np.abs(want).max():.3g}")


@pytest.mark.parametrize("remove_dc", [False, True])
@pytest.mark.parametrize("ntaps", [3, 25])
@pytest.mark.parametrize("n_rank", [1, 2, 8, 16])
def test_order_is_free_over_cluster_ranks(n_rank, ntaps, remove_dc):
    """track_chunk.cu's order: rank shares laid out for the block before
    (two samples longer or shorter), summed per CTA, added in rank order."""
    b = _block(ntaps, seed=100 + ntaps)
    prod, want = _products(b, remove_dc)
    for ch in range(prod.shape[0]):
        num = int(b["num"][ch])
        for num_geom, origin in ((num, 0), (num + 2, 5), (num - 2, 3)):
            total = np.zeros(prod.shape[1:3])
            for rank in range(n_rank):
                lo, hi = tc.rank_share(num, num_geom, rank, n_rank)
                total = total + _cta_sum(prod[ch], lo, hi, origin)
            got = total.astype(np.float32)
            assert np.array_equal(got, want[ch]), (
                f"{n_rank} ranks, channel {ch}: "
                f"{np.abs(got - want[ch]).max():.3g} off; "
                + _magnitudes(prod, want))


@pytest.mark.parametrize("remove_dc", [False, True])
@pytest.mark.parametrize("ntaps", [3, 25])
@pytest.mark.parametrize("n_split", [1, 16, 64])
def test_order_is_free_over_bank_parts(n_split, ntaps, remove_dc):
    """corr_bank.cu's order: parts of whole rows, summed per CTA, added in
    part order."""
    b = _block(ntaps, seed=200 + ntaps)
    prod, want = _products(b, remove_dc)
    for ch in range(prod.shape[0]):
        num = int(b["num"][ch])
        total = np.zeros(prod.shape[1:3])
        for part in range(n_split):
            lo, hi = cb.part_share(num, n_split, part)
            total = total + _cta_sum(prod[ch], lo, hi, (ch * 3 + part) % 8)
        got = total.astype(np.float32)
        assert np.array_equal(got, want[ch]), (
            f"{n_split} parts, channel {ch}: "
            f"{np.abs(got - want[ch]).max():.3g} off; "
            + _magnitudes(prod, want))


@pytest.mark.parametrize("remove_dc", [False, True])
@pytest.mark.parametrize("ntaps", [3, 25])
@pytest.mark.parametrize("n_split", [1, 2, 3, 5, 8, 13, 16])
def test_one_launch_reduction_adds_slots_in_part_order(n_split, ntaps,
                                                       remove_dc):
    """corr_bank.cu's single launch: the parts of a channel finish in any
    order, each leaves its float64 tap sums in its own slot, and whoever
    closes the channel (the part that arrives last, or rank 0 of a cluster
    after its barrier) adds the slots from part 0 up and rounds to float32
    once.  Mirrored with the parts arriving in a shuffled order and CTAs of
    128 threads up to the kernel's most: the plain version's bits."""
    b = _block(ntaps, seed=300 + ntaps)
    prod, want = _products(b, remove_dc)
    rng = np.random.default_rng(n_split)
    for ch in range(prod.shape[0]):
        num = int(b["num"][ch])
        for threads in (128, threads_for(ntaps)):
            slots = np.full((n_split,) + prod.shape[1:3], np.nan)
            for part in rng.permutation(n_split):
                lo, hi = cb.part_share(num, n_split, int(part))
                slots[part] = _cta_sum(prod[ch], lo, hi, (ch + part) % 8,
                                       threads)
            total = np.zeros(prod.shape[1:3])
            for part in range(n_split):
                total = total + slots[part]
            got = total.astype(np.float32)
            assert np.array_equal(got, want[ch]), (
                f"{n_split} parts of {threads} threads, channel {ch}: "
                f"{np.abs(got - want[ch]).max():.3g} off; "
                + _magnitudes(prod, want))


# ------------------------------------------------- (b) one conversion a sample

@pytest.mark.parametrize("remove_dc", [False, True])
def test_convert_once_equals_convert_the_product(remove_dc):
    """(code · iq in float32) → float64 equals code → float64 · iq → float64
    exactly for a ±1 table: the kernel converts the mixed sample once and
    multiplies by the chip as a double."""
    code, iq, _ = _terms(_block(25, seed=7), remove_dc)
    f64 = torch.float64
    assert bool(((code.abs() == 1.0)).all())
    old = (code[:, :, :, None] * iq[:, None, :, :]).to(f64)
    new = code.to(f64)[:, :, :, None] * iq.to(f64)[:, None, :, :]
    assert torch.equal(old, new)


# ----------------------------------------------------- (c) the chip index

def run_chip_indices(base_fp, step_fp, tap_fp, k0, run):
    """The kernel's rule (CorrWork::run in csrc/nco_common.cuh) for the runs
    that start at samples k0 (array): one floor-mod per run, then per sample
    and tap the high word of a 64-bit add plus the run's bias, corrected
    only where it leaves [0, 1023).  Returns (len(k0), run, T) indices and
    how many of them needed the correction."""
    kb = base_fp + k0.astype(np.int64) * step_fp - 1
    hi0 = kb >> 32
    bias = np.mod(hi0, CODE_LENGTH) - hi0
    out = np.empty((len(k0), run, len(tap_fp)), np.int64)
    fixed = 0
    for j in range(run):
        for t, tap in enumerate(tap_fp):
            ci = ((kb + tap) >> 32) + bias
            bad = (ci < 0) | (ci >= CODE_LENGTH)
            fixed += int(bad.sum())
            out[:, j, t] = np.where(bad, np.mod(ci, CODE_LENGTH), ci)
        kb = kb + step_fp
    return out, fixed


@pytest.mark.parametrize("run", [8, 4])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_incremental_chip_index_is_exact(seed, run):
    """Against torch.remainder((base + tap − 1 + k·step) >> 32, 1023) over a
    10 ms block: random code phase (negative indices included), rate, taps
    from −14 to +14 chips, runs that start before sample 0."""
    rng = np.random.default_rng(seed)
    fs = float(rng.uniform(2.0e6, 60e6))
    step_fp = int(round(1.023e6 * (1 + rng.uniform(-5e3, 5e3) / 1575.42e6)
                        / fs * tc.Q32))
    base_fp = int(round(rng.uniform(-0.6, 1.6) * tc.Q32))
    tap_fp = np.round(np.concatenate(
        [[-14.0, 14.0, 0.0], rng.uniform(-14, 14, 8)]) * tc.Q32
    ).astype(np.int64)
    n = int(fs * 10e-3)
    first = -int(rng.integers(0, run))
    k0 = np.arange(first, n, run)
    got, fixed = run_chip_indices(base_fp, step_fp, tap_fp, k0, run)
    k = torch.from_numpy(k0[:, None] + np.arange(run)[None, :])
    want = torch.remainder(torch.bitwise_right_shift(
        (base_fp - 1 + torch.from_numpy(tap_fp))[None, None, :]
        + k[:, :, None] * step_fp, 32), CODE_LENGTH)
    assert np.array_equal(got, want.numpy())
    # the correction is the rare path: a wrap of the code, not every sample
    assert fixed < 0.05 * got.size


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_prepared_code_table_is_the_per_launch_rule(seed):
    """`bank_tables` makes once what every CTA used to make per launch
    (`load_code` in csrc/nco_common.cuh): entry i of a channel's table is
    chip (i − 64) mod 1023 as float64, so the index a run keeps (the high
    word plus the run's bias plus the pad) reads the exact chip while the
    run stays inside the pad, and the wrapped index reads it when it does
    not; taps to ±14 chips, negative indices, runs that start before sample
    0.  The tap words are the taps, zeros, then their least and largest."""
    rng = np.random.default_rng(40 + seed)
    chips = torch.from_numpy(
        rng.choice([-1.0, 1.0], (3, CODE_LENGTH)).astype(np.float32))
    taps = np.concatenate([[-14.0, 14.0, 0.0], rng.uniform(-14, 14, 8)])
    tap_fp = cb.tap_offsets_fp(taps, "cpu")
    tables = cb.bank_tables(chips, tap_fp)
    pad, n_tab = cb.CODE_PAD, cb.TABLE_LEN
    assert tables.code.shape == (3, n_tab) and n_tab % 2 == 0
    assert tables.code.dtype == torch.float64 and tables.ntaps == len(taps)
    i = np.arange(n_tab)
    assert np.array_equal(tables.code.numpy(),
                          chips.numpy()[:, (i - pad) % CODE_LENGTH])
    words = tables.taps.numpy()
    assert words.shape == (tc.MAX_TAPS + 2,) and words.dtype == np.int64
    assert np.array_equal(words[:len(taps)], tap_fp.numpy())
    assert not words[len(taps):tc.MAX_TAPS].any()
    assert words[tc.MAX_TAPS] == tap_fp.min()
    assert words[tc.MAX_TAPS + 1] == tap_fp.max()

    fs = float(rng.uniform(2.0e6, 60e6))
    step_fp = int(round(1.023e6 * (1 + rng.uniform(-5e3, 5e3) / 1575.42e6)
                        / fs * tc.Q32))
    base_fp = int(round(rng.uniform(-0.6, 1.6) * tc.Q32))
    run = 8
    k0 = np.arange(-int(rng.integers(0, run)), int(fs * 2e-3), run)
    kb = base_fp + k0.astype(np.int64) * step_fp - 1
    bias = np.mod(kb >> 32, CODE_LENGTH) - (kb >> 32) + pad
    k = k0[:, None] + np.arange(run)[None, :]
    # with taps to ±14 chips every run stays inside the pad; taps past the
    # pad (±80 chips) also meet the runs that leave it
    for tp in (tap_fp.numpy(), cb.tap_offsets_fp((-80.0, 0.0, 80.0),
                                                 "cpu").numpy()):
        ci = ((kb[:, None, None] + (np.arange(run) * step_fp)[None, :, None]
               + tp[None, None, :]) >> 32) + bias[:, None, None]
        want = np.mod((base_fp - 1 + tp[None, None, :]
                       + k[:, :, None] * step_fp) >> 32, CODE_LENGTH)
        # the kernel's test for a run: its first and last index, least and
        # largest tap, inside the table
        span = (run - 1) * step_fp
        first = ((np.minimum(kb, kb + span) + tp.min()) >> 32) + bias
        last = ((np.maximum(kb, kb + span) + tp.max()) >> 32) + bias
        safe = (first >= 0) & (last < CODE_LENGTH + 2 * pad)
        if abs(tp).max() <= 14 * tc.Q32:
            assert safe.all()
        else:
            assert 0 < safe.sum() < len(safe)       # both paths are met
        assert ci[safe].min() >= 0 and ci[safe].max() < n_tab
        wrapped = np.mod(ci - pad, CODE_LENGTH) + pad
        for ch in range(3):
            table, code = tables.code.numpy()[ch], chips.numpy()[ch]
            assert np.array_equal(table[ci[safe]], code[want[safe]])
            assert np.array_equal(table[wrapped[~safe]], code[want[~safe]])


# ------------------------------------------------------ (d) share geometry

def test_cluster_size_rule():
    """Largest power of two up to the portable maximum that leaves every
    channel's cluster SMs of its own; one CTA past 66 channels."""
    assert tc.cluster_size(8, 132) == 8
    assert tc.cluster_size(1, 132) == 8
    assert tc.cluster_size(16, 132) == 8
    assert tc.cluster_size(17, 132) == 4
    assert tc.cluster_size(33, 132) == 4
    assert tc.cluster_size(34, 132) == 2
    assert tc.cluster_size(66, 132) == 2
    assert tc.cluster_size(67, 132) == 1
    assert tc.cluster_size(500, 132) == 1
    for n_ch in range(1, 200):
        c = tc.cluster_size(n_ch, 132)
        assert c == 1 or n_ch * c <= 132


def test_default_split_is_one_wave_of_parts_worth_their_setup():
    """One CTA an SM at most, parts never shorter than MIN_PART_ROWS rows, so
    a short block gets fewer parts than a long one; never fewer than one.
    A CTA has 256 threads unless a part gives each of 512 two runs."""
    blk1, blk10 = 58368, 580352        # 58 MHz: pdi·S + 256, rounded to 128
    assert cb.default_split(8, blk1) == cb.default_split(8, blk10) == 16
    assert cb.default_split(8, 4352) == 2 < cb.default_split(8, 20480) == 13
    assert cb.default_split(4, blk1) == 33 and cb.default_split(12, blk1) == 11
    assert cb.default_threads(3, 16, blk1) == 256 == cb.threads_for(29)
    assert cb.default_threads(3, 16, blk10) == 512 == cb.threads_for(3)
    assert cb.default_threads(29, 16, blk10) == 256
    assert cb.default_threads(25, 1, 4352) == cb.default_threads(3, 1, 128) \
        == 256
    assert cb.default_split(8, 128) == 1
    assert cb.default_split(1000, blk10) == 1
    for n_ch in (1, 2, 8, 12, 64, 300):
        for blk in (128, 4352, 20480, blk1, blk10):
            k = cb.default_split(n_ch, blk)
            assert k >= 1 and (k == 1 or n_ch * k <= cb.SM_COUNT)
            assert k == 1 or (blk // 128) // k >= cb.MIN_PART_ROWS
            if blk > 128:
                assert k >= cb.default_split(n_ch, blk // 2)


@pytest.mark.parametrize("entry", ["corr_bank_kernel",
                                   "corr_bank_windows_kernel"])
def test_default_threads_fit_the_instance_that_is_launched(entry):
    """For every tap count, split and block length, the threads the wrapper
    asks for are no more than the instance csrc/corr_bank.cu launches for
    that tap count was compiled for (its `__launch_bounds__`): a tap count
    without an instance of its own runs the one that reads its tap count at
    run time, built for 256 threads however few the taps.  The instances
    are read from the source."""
    src = (Path(cb._build.CSRC) / "corr_bank.cu").read_text()
    compiled = {int(a) for a, b in re.findall(
        r"case (\d+): BANK_LAUNCH\(%s, (\d+)," % entry, src) if a == b}
    assert 3 in compiled and compiled <= {3, 25, 29}
    assert f"default: BANK_LAUNCH({entry}, 0," in src
    for ntaps in range(1, tc.MAX_TAPS + 1):
        limit = threads_for(ntaps if ntaps in compiled else 0)
        assert cb.threads_for(ntaps) <= limit
        for blk in (128, 4352, 58368, 580352):
            for n_split in (1, 2, 16, 33):
                t = cb.default_threads(ntaps, n_split, blk)
                assert 128 <= t <= limit and t % 32 == 0
    # the few-tap instance does get its 16 warps where a part is long enough
    assert cb.default_threads(3, 1, 58368) == 512
    assert cb.default_threads(2, 1, 58368) == cb.default_threads(
        4, 16, 580352) == 256


@pytest.mark.parametrize("seed", range(4))
def test_rank_and_part_shares_partition_the_block(seed):
    """Every sample of [0, num) falls to exactly one rank (whatever block
    length the shares were laid out for) and to exactly one part; blocks
    shorter than a row and empty shares included."""
    rng = np.random.default_rng(seed)
    for _ in range(300):
        num = int(rng.choice([1, 5, 127, 128, 129, int(rng.integers(1, 70000))]))
        geom = max(1, num + int(rng.integers(-300, 300)))
        for n_rank in (1, 2, 4, 8, 16):
            count = np.zeros(num, np.int64)
            for rank in range(n_rank):
                lo, hi = tc.rank_share(num, geom, rank, n_rank)
                assert 0 <= lo <= num and lo <= max(lo, hi) <= num
                if rank < n_rank - 1 and hi < num:
                    assert hi % 128 == 0
                assert lo % 128 == 0 or lo == num
                count[lo:hi] += 1
            assert (count == 1).all()
        for n_split in (1, 7, 16, 64, 600):
            count = np.zeros(num, np.int64)
            for part in range(n_split):
                lo, hi = cb.part_share(num, n_split, part)
                assert lo % 128 == 0 or lo == num
                count[lo:hi] += 1
            assert (count == 1).all()


class ShareMirror:
    """`Share` of csrc/nco_common.cuh: the tiles of the samples [k_lo, k_hi)
    of a block whose first pair has byte address `addr0`."""

    def __init__(self, addr0, pair_bytes, tile_bytes, k_lo, k_hi):
        self.g = 16 // pair_bytes
        self.tp = tile_bytes // pair_bytes
        self.k_lo, self.k_hi = k_lo, k_hi
        # block-sample index of the first tile's first pair
        self.k0 = k_lo - tc.tile_origin(addr0 + k_lo * pair_bytes, pair_bytes)
        self.n_tiles = -(-(k_hi - self.k0) // self.tp) if k_hi > k_lo else 0

    def need(self, i):
        if i >= self.n_tiles:
            return 0
        rest = self.k_hi - (self.k0 + i * self.tp)
        return min(self.tp, -(-rest // self.g) * self.g)


@pytest.mark.parametrize("pair_bytes", [2, 4])
@pytest.mark.parametrize("seed", range(3))
def test_tiles_cover_a_share_from_an_aligned_origin(seed, pair_bytes):
    """A share's tiles start on a 16-byte address at most one piece before
    the share, are whole 16-byte pieces, and together hold every sample of
    the share exactly once; ranks' tiles hold every sample of the block."""
    rng = np.random.default_rng(10 + seed)
    for _ in range(200):
        tile_bytes = int(rng.choice([16384, 32768]))
        addr0 = 4096 + pair_bytes * int(rng.integers(0, 64))
        num = int(rng.choice([3, 100, int(rng.integers(1, 130000))]))
        n_rank = int(rng.choice([1, 2, 8, 16]))
        geom = max(1, num + int(rng.integers(-3, 4)))
        count = np.zeros(num, np.int64)
        for rank in range(n_rank):
            lo, hi = tc.rank_share(num, geom, rank, n_rank)
            sh = ShareMirror(addr0, pair_bytes, tile_bytes, lo, hi)
            assert (addr0 + sh.k0 * pair_bytes) % 16 == 0
            assert 0 <= lo - sh.k0 < sh.g
            for i in range(sh.n_tiles):
                n = sh.need(i)
                assert n % sh.g == 0 and 0 < n <= sh.tp
                t0 = sh.k0 + i * sh.tp
                a, b = max(lo, t0), min(hi, t0 + n)
                assert min(hi, t0 + sh.tp) == b     # nothing wanted is unstaged
                count[a:b] += 1
            assert sh.need(sh.n_tiles) == 0
        assert (count == 1).all()


@pytest.mark.parametrize("seed", range(3))
def test_staged_ahead_plus_top_up_covers_the_first_tile(seed):
    """What a rank stages ahead for block n+1 (laid out for block n's length
    plus a margin, from the same origin) and tops up when block n+1's length
    is known holds the first tile of its share, for lengths that move by a
    few samples and by more than the margin."""
    rng = np.random.default_rng(20 + seed)
    margin, pair_bytes, tile_bytes = 256, 2, 32768
    for _ in range(300):
        num = int(rng.integers(2000, 70000))             # block n
        nxt = max(1, num + int(rng.choice(
            [-2, -1, 0, 1, 2, int(rng.integers(-1500, 1500))])))
        addr1 = 4096 + pair_bytes * int(rng.integers(0, 64))   # block n+1
        n_rank = int(rng.choice([1, 2, 8, 16]))
        for rank in range(n_rank):
            lo_p, hi_p = tc.rank_share(num + margin, num, rank, n_rank)
            ahead = ShareMirror(addr1, pair_bytes, tile_bytes, lo_p, hi_p)
            staged = ahead.need(0) if lo_p < num and lo_p < hi_p else 0
            lo, hi = tc.rank_share(nxt, num, rank, n_rank)
            sh = ShareMirror(addr1, pair_bytes, tile_bytes, lo, hi)
            have = staged if staged and ahead.k0 == sh.k0 else 0
            if hi > lo and lo == lo_p and staged:
                assert have == staged          # the same origin: it is used
            need = sh.need(0)
            top_up = (have, need) if need > have else None
            held = max(have, need)
            assert held >= min(hi, sh.k0 + sh.tp) - sh.k0 or hi <= lo
            if top_up:
                assert top_up[0] % sh.g == 0 and top_up[1] % sh.g == 0
            if abs(nxt - num) <= 2 and hi > lo and rank < n_rank - 1:
                assert top_up is None          # the usual block: no top-up


# ------------------------------------------------------ (e) the prepared launch

def _plan_words(b):
    return (b["off"], b["rem"], b["step"] * FS, b["phase"], b["carr_fp"],
            b["num"])


@pytest.mark.parametrize("remove_dc", [False, True])
@pytest.mark.parametrize("ntaps", [3, 25])
def test_bank_plan_on_the_cpu_is_the_plain_version(ntaps, remove_dc):
    """A `BankPlan` made once and called with the six per-block words gives
    `correlator_bank_reference`'s bits, call after call, raises its flag the
    same way, and `correlator_bank` (built on it) too; no kernel launch is
    counted on the CPU."""
    b = _block(ntaps, seed=400 + ntaps)
    flag = cb.new_fault("cpu")
    plan = cb.BankPlan(b["raw"], b["chips"], b["tap_fp"], FS, b["blk"],
                       remove_dc, flag)
    before = cb.correlator_bank.launches
    for shift in (0, 7):
        words = list(_plan_words(b))
        words[0] = words[0] + shift
        want, _ = cb.correlator_bank_reference(
            b["raw"], *words, b["chips"], b["tap_fp"], FS, b["blk"],
            remove_dc)
        assert torch.equal(plan(*words), want)
        got, _ = cb.correlator_bank(b["raw"], *words, b["chips"],
                                    b["tap_fp"], FS, b["blk"], remove_dc)
        assert torch.equal(got, want)
    assert int(flag[0]) == 0 and cb.correlator_bank.launches == before
    words = list(_plan_words(b))
    words[5] = words[5].clone()
    words[5][1] = b["blk"] + 1
    out = plan(*words)
    assert int(flag[0]) == 2 and not out[1].any()
    with pytest.raises(RuntimeError, match="channel 1"):
        cb.raise_on_fault(plan.fault)


def test_bank_plan_checks_once_and_per_call():
    """What `correlator_bank` refuses, the plan refuses: the chunk, the
    code tables, the taps, the block window and the flag when it is made;
    the six words' dtype, shape, device and contiguity at every call."""
    b = _block(3, seed=9)
    good = (b["raw"], b["chips"], b["tap_fp"], FS, b["blk"])
    i64 = torch.int64
    for bad in (
            (b["raw"].to(torch.float32),) + good[1:],
            (b["raw"][:, :1],) + good[1:],
            (b["raw"], b["chips"][:, :1000]) + good[2:],
            (b["raw"], b["chips"].double()) + good[2:],
            good[:2] + (torch.zeros(33, dtype=i64),) + good[3:],
            good[:2] + (b["tap_fp"].to(torch.int32),) + good[3:],
            good[:4] + (b["blk"] + 1,), good[:4] + (0,)):
        with pytest.raises(ValueError):
            cb.BankPlan(*bad)
    with pytest.raises(ValueError, match="fault"):
        cb.BankPlan(*good, fault=torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="no channels"):
        cb.BankPlan(b["raw"], b["chips"][:0], *good[2:])
    plan = cb.BankPlan(*good)
    words = _plan_words(b)
    plan(*words)
    wide = torch.zeros((2, 2), dtype=i64)
    for i, t in ((0, words[0].to(torch.int32)), (1, words[1].float()),
                 (5, words[5][:1]), (3, wide[:, 0]), (2, words[2].to(i64))):
        bad = list(words)
        bad[i] = t
        with pytest.raises(ValueError, match=("ptr_off", "rem_chip",
                                              "code_freq", "phase_fp",
                                              "carr_fp", "num")[i]):
            plan(*bad)


@pytest.mark.parametrize("remove_dc", [False, True])
@pytest.mark.parametrize("ntaps", [3, 25])
def test_windows_plan_on_the_cpu_is_the_plain_version(ntaps, remove_dc):
    """A `WindowsPlan` made once and called with the windows and the five
    per-block words gives `correlator_bank_windows_reference`'s bits, a new
    tensor at every call, equal to `correlator_bank_windows` (built on it)
    and to the fetching bank on the same samples; it raises its flag the
    same way and counts no kernel launch on the CPU."""
    b = _block(ntaps, seed=500 + ntaps)
    flag = cb.new_fault("cpu")
    plan = cb.WindowsPlan(b["chips"], b["tap_fp"], FS, b["blk"], remove_dc,
                          flag)
    before = cb.correlator_bank_windows.launches
    words = _plan_words(b)
    kept = []
    for shift in (0, 7):
        win = cb.cut_windows(b["raw"], words[0] + shift, b["blk"])
        want, _ = cb.correlator_bank_windows_reference(
            win, *words[1:], b["chips"], b["tap_fp"], FS, remove_dc)
        got = plan(win, *words[1:])
        assert torch.equal(got, want)
        kept.append((got, want))
        entry, _ = cb.correlator_bank_windows(
            win, *words[1:], b["chips"], b["tap_fp"], FS, remove_dc)
        fetched, _ = cb.correlator_bank(
            b["raw"], words[0] + shift, *words[1:], b["chips"], b["tap_fp"],
            FS, b["blk"], remove_dc)
        assert torch.equal(entry, want) and torch.equal(fetched, want)
    assert all(torch.equal(got, want) for got, want in kept)
    assert kept[0][0].data_ptr() != kept[1][0].data_ptr()
    assert int(flag[0]) == 0 and plan.captured == 0
    assert cb.correlator_bank_windows.launches == before
    num = words[5].clone()
    num[1] = b["blk"] + 1
    out = plan(win, *words[1:5], num)
    assert int(flag[0]) == 2 and not out[1].any()
    with pytest.raises(RuntimeError, match="channel 1"):
        cb.raise_on_fault(plan.fault)


def test_windows_plan_checks_once_and_per_call():
    """What `correlator_bank_windows` refuses, the plan refuses: the code
    tables, the taps, the window length and the flag when it is made; the
    windows' and the five words' dtype, shape and contiguity at every
    call."""
    b = _block(3, seed=11)
    good = (b["chips"], b["tap_fp"], FS, b["blk"])
    i64 = torch.int64
    for bad in (
            (b["chips"][:, :1000],) + good[1:],
            (b["chips"].double(),) + good[1:],
            good[:1] + (torch.zeros(33, dtype=i64),) + good[2:],
            good[:1] + (b["tap_fp"].to(torch.int32),) + good[2:],
            good[:3] + (b["blk"] + 1,), good[:3] + (0,)):
        with pytest.raises(ValueError):
            cb.WindowsPlan(*bad)
    with pytest.raises(ValueError, match="fault"):
        cb.WindowsPlan(*good, fault=torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="no channels"):
        cb.WindowsPlan(b["chips"][:0], *good[1:])
    plan = cb.WindowsPlan(*good)
    words = _plan_words(b)
    win = cb.cut_windows(b["raw"], words[0], b["blk"])
    plan(win, *words[1:])
    twice = torch.stack([win, win], 1)
    for bad_win in (win.float(), win[:, :-128], win[:1], twice[:, 0]):
        with pytest.raises(ValueError, match="win must be"):
            plan(bad_win, *words[1:])
    wide = torch.zeros((2, 2), dtype=i64)
    for i, t in ((1, words[1].float()), (5, words[5][:1]), (3, wide[:, 0]),
                 (2, words[2].to(i64)), (4, words[4].to(torch.int32))):
        bad = list(words)
        bad[i] = t
        with pytest.raises(ValueError, match=("ptr_off", "rem_chip",
                                              "code_freq", "phase_fp",
                                              "carr_fp", "num")[i]):
            plan(win, *bad[1:])
