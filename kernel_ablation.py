#!/usr/bin/env python3
"""What each part of the kernels' design is worth on the card.

    python3 kernel_ablation.py

Builds the kernels as they are, and once more for each variant below: a
scratch copy of gps_sdr_tpu_torch/csrc/ under build/ablation/ with one part
of the design taken out again (the tree's sources are not touched).  Every
build is timed on chip_smoke.py's phase-2 workload (58 MHz int8, 8
channels): track_chunk over 1000 E/P/L blocks and over 300 blocks of the
25-tap bank (CUDA events over the wrapper call), correlator_bank_windows at
1 ms and 10 ms, 3 taps, and the prepared correlator_bank (BankPlan) at 3 and
29 taps (device time per launch from a replayed CUDA graph).
One JSON line per variant; the variants differ from `as_is` only in time
(`equal_to_as_is` says so), except `no_samples`, which correlates nothing
and shows what a block costs beside its samples, and `no_reduction`, which
leaves a channel's partial sums unadded.

Variants, by what they put back:
  one_cta_per_channel   no cluster: one CTA per channel (no source change)
  sync_2byte_loads      tiles filled by 2-byte loads that are waited for,
                        not by 16-byte asynchronous copies
  no_stage_ahead        the next block's first tile is not staged while
                        this block is correlated
  convert_per_tap       float32 chip x sample converted to float64 per tap,
                        not the mixed sample once
  mod_per_sample_tap    `mod 1023` for every sample and tap, not once per run
  serial_tail           thread 0 alone closes the loops and hands the state
                        back through shared memory and a barrier
  per_cta_tables        every CTA of a bank makes the code table itself at
                        every launch (a conversion and a `mod 1023` per
                        entry, the taps' least and largest on one thread),
                        not 16-byte copies of tables made once
  no_reduction          the banks' parts leave their sums in their slots and
                        nobody adds them: what the ticket and the last
                        part's sum cost
  cluster_reduction     the parts of a bank's channel are a thread-block
                        cluster (2, 4 or 8, the portable size): every rank
                        writes its sums into rank 0's shared memory and
                        rank 0 adds them in rank order after one cluster
                        barrier; no slots, no ticket.  Its line gives the
                        prepared correlator_bank by parts per channel, to be
                        read beside `ticket_by_parts` of `bank_design`
Beside them, `bank_design`: the prepared correlator_bank as built, by parts
per channel, by threads per CTA (the wrapper's rule overridden), for 2, 4, 8
and 12 channels, and followed by an empty launch (what a second kernel would
add).
Last, `section_clocks`: track_chunk with clock64() read between the sections
of a block and written into the records in place of their values; the line
gives each section's mean cycles per block on rank 0 of channel 0.  And
`bank_section_clocks`: the same for one launch of the prepared bank, written
into the parts' slots; mean cycles over all CTAs.
"""

from __future__ import annotations

import contextlib
import json
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

import chip_smoke as cs
from gps_sdr_tpu_torch.ops import _build
from gps_sdr_tpu_torch.ops import corr_bank as cb
from gps_sdr_tpu_torch.ops import track_chunk as tc

CSRC = _build.CSRC
SCRATCH = _build.BUILD_DIR / "ablation"

SERIAL_TAIL_FROM = "    const float e_i = total(2 * p.i_early)"
SERIAL_TAIL_TO = "    if (rank == 0 && tid == 0) {\n      rec_f[0 * plane + row]"
SERIAL_TAIL = """
    __shared__ double s_next[7];
    __shared__ long long s_ptr_next;
    __shared__ unsigned s_phase_next;
    if (tid == 0) {
      const float e_i = total(2 * p.i_early), e_q = total(2 * p.i_early + 1);
      const float p_i = total(2 * p.i_prompt), p_q = total(2 * p.i_prompt + 1);
      const float l_i = total(2 * p.i_late), l_q = total(2 * p.i_late + 1);
      const double e = (double)sqrtf(e_i * e_i + e_q * e_q);
      const double l = (double)sqrtf(l_i * l_i + l_q * l_q);
      const double ce = 0.5 * (e - l) / fmax(e + l, 1e-30);
      const double d = dll_nco + p.dll_a * (ce - dll_last) + ce * p.dll_b;
      const float safe_pi = p_i == 0.f ? 1e-30f : p_i;
      const double ca = (double)(atanf(p_q / safe_pi) / (float)kTwoPi);
      const double q = pll_nco + p.pll_a * (ca - pll_last) + ca * p.pll_b;
      s_next[0] = ce; s_next[1] = d;
      s_next[2] = p.code_freq_basis + p.dll_freq_sign * d;
      s_next[3] = ca; s_next[4] = q; s_next[5] = carr_basis + q;
      s_next[6] = (double)num * step_c + rem - (double)p.n_chips;
      s_phase_next = phase + (unsigned)num * carr_fp;
      s_ptr_next = ptr + num;
    }
    __syncthreads();
    const double code_err = s_next[0], dll = s_next[1];
    const double code_freq_new = s_next[2], carr_err = s_next[3];
    const double pll = s_next[4], carr_freq_new = s_next[5];
    const double rem_new = s_next[6];
    const unsigned phase_new = s_phase_next;
    const long long ptr_new = s_ptr_next;
    __syncthreads();

"""

# variant -> {file: [(old, new), ...]}; every `old` must occur exactly once
VARIANTS = {
    "as_is": {},
    "sync_2byte_loads": {"nco_common.cuh": [
        ("    if (a >= 0 && a + G <= n_raw) {\n      cp_async16(dst, raw + a);",
         "    if (false) {\n      cp_async16(dst, raw + a);")]},
    "no_stage_ahead": {"track_chunk.cu": [
        ("      ahead_have = 0;\n      if (step + 1 < p.n_steps) {",
         "      ahead_have = 0;\n      if (false) {")]},
    "convert_per_tap": {"nco_common.cuh": [
        ("            acc_i[t_] = fma(cv, di, acc_i[t_]);\n"
         "            acc_q[t_] = fma(cv, dq, acc_q[t_]);",
         "            acc_i[t_] += (double)((float)cv * (live ? mi : 0.f));\n"
         "            acc_q[t_] += (double)((float)cv * (live ? mq : 0.f));")]},
    "mod_per_sample_tap": {"nco_common.cuh": [
        ("      if (first >= 0 && last < kCodeLen + 2 * kPad)\n",
         "      if (false)\n")]},
    "serial_tail": {"track_chunk.cu": "serial_tail"},
    "section_clocks": {"track_chunk.cu": [
        ("  for (int step = 0; step < p.n_steps; ++step) {\n",
         "  long long c_end = clock64();\n"
         "  for (int step = 0; step < p.n_steps; ++step) {\n"
         "    const long long c0 = clock64();\n"),
        ("    const int par = step & 1;\n",
         "    const int par = step & 1;\n    const long long c1 = clock64();\n"),
        ("    load_r_phasors<ShareT::kRows>(carr_fp);\n",
         "    load_r_phasors<ShareT::kRows>(carr_fp);\n"
         "    const long long c2 = clock64();\n"),
        ("    walk(sh, xs, p.n_raw, t_cur, t_ring, work, ahead);\n",
         "    walk(sh, xs, p.n_raw, t_cur, t_ring, work, ahead);\n"
         "    const long long c3 = clock64();\n"),
        ("    if (tid < 2 * ntaps) {\n      for (int r = 0; r < n_rank; ++r)\n"
         "        *cluster.map_shared_rank(&s_x[par][rank][tid], r) = mine;",
         "    const long long c4 = clock64();\n"
         "    if (tid < 2 * ntaps) {\n      for (int r = 0; r < n_rank; ++r)\n"
         "        *cluster.map_shared_rank(&s_x[par][rank][tid], r) = mine;"),
        ("    cluster.sync();  // the one barrier of a block (two with DC "
         "removal)\n",
         "    cluster.sync();\n    const long long c5 = clock64();\n"),
        ("    const long long ptr_new = ptr + num;\n",
         "    const long long ptr_new = ptr + num;\n"
         "    const long long c6 = clock64();\n"),
        ("      rec_f[0 * plane + row] = code_err;\n"
         "      rec_f[1 * plane + row] = carr_err;\n"
         "      rec_f[2 * plane + row] = code_freq_new;\n"
         "      rec_f[3 * plane + row] = carr_freq_new;\n"
         "      rec_f[4 * plane + row] = rem_new;\n"
         "      rec_i[0 * plane + row] = num;\n"
         "      rec_i[1 * plane + row] = ptr_new;\n"
         "      rec_i[2 * plane + row] = (long long)(int)phase_new;\n",
         "      rec_f[0 * plane + row] = (double)(c1 - c0);\n"
         "      rec_f[1 * plane + row] = (double)(c2 - c1);\n"
         "      rec_f[2 * plane + row] = (double)(c3 - c2);\n"
         "      rec_f[3 * plane + row] = (double)(c4 - c3);\n"
         "      rec_f[4 * plane + row] = (double)(c5 - c4);\n"
         "      rec_i[0 * plane + row] = num;\n"
         "      rec_i[1 * plane + row] = c0 - c_end;\n"
         "      rec_i[2 * plane + row] = c6 - c5;\n"),
        ("    num_geom = num;\n  }\n",
         "    num_geom = num;\n    c_end = clock64();\n  }\n")]},
    "per_cta_tables": {"nco_common.cuh": [
        ("  for (int c = threadIdx.x; c < kCodePieces + kTapPieces; "
         "c += blockDim.x) {\n"
         "    if (c < kCodePieces)\n"
         "      cp_async16(&tb.chips[2 * c], code + 2 * c);\n"
         "    else\n"
         "      cp_async16(&tb.tap[2 * (c - kCodePieces)],\n"
         "                 taps + 2 * (c - kCodePieces));\n"
         "  }\n",
         "  for (int i = threadIdx.x; i < kTableLen; i += blockDim.x)\n"
         "    tb.chips[i] = (double)(float)code[kPad + "
         "floor_mod_code(i - kPad)];\n"
         "  if (threadIdx.x < kMaxTaps) tb.tap[threadIdx.x] = "
         "taps[threadIdx.x];\n"
         "  if (threadIdx.x == 0) {\n"
         "    long long lo = taps[kMaxTaps], hi = taps[kMaxTaps + 1];\n"
         "    for (int t_ = 0; t_ < kMaxTaps; ++t_) {\n"
         "      lo = min(lo, taps[t_]);\n"
         "      hi = max(hi, taps[t_]);\n"
         "    }\n"
         "    tb.tap[kMaxTaps] = lo;\n"
         "    tb.tap[kMaxTaps + 1] = hi;\n"
         "  }\n")]},
    "no_reduction": {"corr_bank.cu": [
        ("      s_last = atomicAdd(p.ticket + ch, 1) == p.n_split - 1;\n",
         "      s_last = 0;\n")]},
    "cluster_reduction": {"corr_bank.cu": [
        ('#include "nco_common.cuh"\n\nnamespace {\n\n',
         '#include <cooperative_groups.h>\n\n#include "nco_common.cuh"\n\n'
         "namespace {\n\nnamespace cg = cooperative_groups;\n"),
        ("  __shared__ int s_last;\n",
         "  __shared__ int s_last;\n"
         "  __shared__ double s_x[8][2 * kMaxTaps];  // rank 0's\n"),
        ("  } else {\n    // every part into its slot;",
         "  } else if (true) {\n"
         "    cg::cluster_group cluster = cg::this_cluster();\n"
         "    if (tid < 2 * ntaps) *cluster.map_shared_rank(&s_x[part][tid], 0)"
         " = v;\n"
         "    cluster.sync();\n"
         "    if (part == 0 && tid < 2 * ntaps) {\n"
         "      double total = 0.0;\n"
         "      for (int s = 0; s < p.n_split; ++s) total += s_x[s][tid];\n"
         "      out[tid] = (float)total;\n"
         "    }\n"
         "  } else {\n    // every part into its slot;"),
        ("  return cudaLaunchKernel(func, dim3(p.n_ch, p.n_split), "
         "dim3(p.threads), args,\n"
         "                          kSmemBytes, stream);\n",
         "  if (p.n_split > 8) return cudaErrorInvalidValue;\n"
         "  cudaLaunchAttribute attr;\n"
         "  attr.id = cudaLaunchAttributeClusterDimension;\n"
         "  attr.val.clusterDim.x = 1;\n"
         "  attr.val.clusterDim.y = p.n_split;\n"
         "  attr.val.clusterDim.z = 1;\n"
         "  cudaLaunchConfig_t cfg = {};\n"
         "  cfg.gridDim = dim3(p.n_ch, p.n_split);\n"
         "  cfg.blockDim = dim3(p.threads);\n"
         "  cfg.dynamicSmemBytes = kSmemBytes;\n"
         "  cfg.stream = stream;\n"
         "  cfg.attrs = &attr;\n"
         "  cfg.numAttrs = 1;\n"
         "  return cudaLaunchKernelExC(&cfg, func, args);\n")]},
    "bank_section_clocks": {"corr_bank.cu": [
        ("  ShareT sh;\n  part_share(&sh, p, raw, b.off, b.num);\n",
         "  const long long c0 = clock64();\n"
         "  ShareT sh;\n  part_share(&sh, p, raw, b.off, b.num);\n"),
        ("  load_r_phasors<ShareT::kRows>(carr_fp);\n",
         "  load_r_phasors<ShareT::kRows>(carr_fp);\n"
         "  const long long c1 = clock64();\n"),
        ("  walk(sh, raw, p.n_raw, t0, t1, work, NoAhead());\n\n"
         "  const double v = cta_tap_sum<NT>(work.acc_i, work.acc_q, ntaps, "
         "s_part);\n",
         "  walk(sh, raw, p.n_raw, t0, t1, work, NoAhead());\n"
         "  const long long c2 = clock64();\n"
         "  const double v = cta_tap_sum<NT>(work.acc_i, work.acc_q, ntaps, "
         "s_part);\n"
         "  const long long c3 = clock64();\n"),
        ("      if (tid == 0) p.ticket[ch] = 0;\n    }\n  }\n}\n",
         "      if (tid == 0) p.ticket[ch] = 0;\n    }\n  }\n"
         "  const long long c4 = clock64();\n"
         "  __syncthreads();\n"
         "  if (tid == 0) {\n"
         "    double* d = slot_of(p, ch, part);\n"
         "    d[0] = (double)(c1 - c0); d[1] = (double)(c2 - c1);\n"
         "    d[2] = (double)(c3 - c2); d[3] = (double)(c4 - c3);\n"
         "  }\n}\n")]},
    "no_samples": {"nco_common.cuh": [
        ("    if (hi <= lo) return;\n    const int q0 = lo >> 7;\n"
         "    long long tap_r",
         "    return;\n    const int q0 = lo >> 7;\n    long long tap_r")]},
}


def make_sources(name: str) -> Path:
    """The scratch copy of csrc/ for one variant."""
    dst = SCRATCH / name / "csrc"
    if dst.exists():
        shutil.rmtree(dst)
    shutil.copytree(CSRC, dst)
    for fname, edits in VARIANTS[name].items():
        path = dst / fname
        text = path.read_text()
        if edits == "serial_tail":
            i, j = text.index(SERIAL_TAIL_FROM), text.index(SERIAL_TAIL_TO)
            text = text[:i] + SERIAL_TAIL + text[j:]
        else:
            for old, new in edits:
                if text.count(old) != 1:
                    raise RuntimeError(f"{name}: {fname} no longer holds "
                                       f"{old!r} exactly once")
                text = text.replace(old, new)
        path.write_text(text)
    return dst


def compile_one(src_dir: Path, lib: str) -> Path:
    out = src_dir.parent / f"{lib}.so"
    cmd = [_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
           "-std=c++17", "-O3", "-fmad=false", "-shared", "-Xcompiler",
           "-fPIC", "-o", str(out), str(src_dir / f"{lib}.cu")]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"{src_dir}: nvcc failed\n{res.stdout}{res.stderr}")
    return out


def use_libraries(paths: dict) -> None:
    """Point both wrappers at one variant's libraries."""
    for mod, lib in ((tc, "track_chunk"), (cb, "corr_bank")):
        mod.load_library.cache_clear()
    real = _build.build_library
    _build.build_library = lambda name, *a, **k: (paths[name], "", 0.0)
    try:
        tc.load_library()
        cb.load_library()
    finally:
        _build.build_library = real


def windows_args(work: dict, state, pdi: int, dev) -> tuple:
    """Arguments of correlator_bank_windows for one block of `pdi` ms of
    every channel from the tracked `state`, 3 taps."""
    cfg = work["cfg"]
    S = cfg.signal.samples_per_ms
    blk = -(-(pdi * S + 256) // 128) * 128
    start = int(state.ptr.min())
    raw = work["stager"].stage(work["src"].read_iq_values(start, blk + 2 * S))
    num = torch.ceil((1023.0 * pdi - state.rem_chip)
                     / (state.code_freq / cs.FS)).to(torch.int64)
    carr_fp = torch.round(state.carr_freq / cs.FS * tc.Q32).to(torch.int64)
    win = cb.cut_windows(raw, state.ptr - start, blk)
    taps = cb.tap_offsets_fp(cs.TrackParams.epl(cfg).taps, dev)
    return (win, state.rem_chip, state.code_freq,
            state.phase_fp.to(torch.int64), carr_fp, num, work["chips"], taps,
            cs.FS, False)


def bank_args(work: dict, state, dev, channels: int = 8) -> tuple:
    """(chunk, code tables, the six per-block words, block window) of one
    1 ms block of `channels` channels from the tracked `state` (past its 8,
    the first again with their windows 1000 samples on)."""
    cfg = work["cfg"]
    S = cfg.signal.samples_per_ms
    blk = -(-(S + 256) // 128) * 128
    start = int(state.ptr.min())
    raw = work["stager"].stage(work["src"].read_iq_values(start, 3 * S))
    n = state.ptr.shape[0]
    idx = torch.arange(channels, device=dev) % n
    ptr = state.ptr[idx] + 1000 * (torch.arange(channels, device=dev) // n)
    rem, freq = state.rem_chip[idx].contiguous(), \
        state.code_freq[idx].contiguous()
    words = (ptr - start, rem, freq,
             state.phase_fp.to(torch.int64)[idx].contiguous(),
             torch.round(state.carr_freq[idx] / cs.FS * tc.Q32
                         ).to(torch.int64),
             torch.ceil((1023.0 - rem) / (freq / cs.FS)).to(torch.int64))
    return raw, work["chips"][idx].contiguous(), words, blk


@contextlib.contextmanager
def threads_of(threads):
    """Every bank CTA of a launch prepared inside gets `threads` threads
    (None: the wrapper's rule stands)."""
    rule = cb.default_threads
    if threads is not None:
        cb.default_threads = lambda ntaps, n_split, blk: threads
    try:
        yield
    finally:
        cb.default_threads = rule


def bank_us(args: tuple, taps, dev, tail=None, n_split=None, threads=None
            ) -> tuple:
    """(µs per launch of the prepared bank from a replayed graph, its
    result); `tail()` is called after every launch."""
    raw, chips, words, blk = args
    with threads_of(threads):
        plan = cb.BankPlan(raw, chips, cb.tap_offsets_fp(taps, dev), cs.FS,
                           blk, n_split=n_split)

    def call():
        plan(*words)
        if tail:
            tail()

    out = plan(*words).clone()
    cb.raise_on_fault(plan.fault)
    return 1e3 * cs.timed_graph_ms(call, 10), out


def bank_design(work: dict, state, dev) -> dict:
    """The prepared bank as built, over its launch parameters."""
    grids = {"3taps": cs.VTParams().taps,
             "29taps": cs.VTParams.multicorr().taps}
    res = {}
    for name, taps in grids.items():
        args = bank_args(work, state, dev)
        base_us, base = bank_us(args, taps, dev)
        r = {"default_us": base_us,
             "then_empty_launch_us": bank_us(
                 args, taps, dev, tail=lambda: cb.empty_launch(dev))[0]}
        equal = True
        for label, kw, values in (
                ("ticket_by_parts", "n_split", (1, 2, 4, 8, 12, 16, 32)),
                ("by_threads", "threads",
                 (128, 256, 512) if len(taps) == 3 else (128, 256))):
            r[label] = {}
            for v in values:
                us, out = bank_us(args, taps, dev, **{kw: v})
                r[label][str(v)] = us
                equal &= bool(torch.equal(out, base))
        for channels in (2, 4, 12):
            sub = bank_args(work, state, dev, channels)
            r[f"{channels}_channels_by_parts"] = {
                str(k): bank_us(sub, taps, dev, n_split=k)[0]
                for k in sorted({8, 11, 16, 24, 32, 48, 64,
                                 cb.default_split(channels, sub[3])})
                if channels * k <= 2 * cb.SM_COUNT}
        r["4_channels_32_parts_by_threads"] = {
            str(t): bank_us(bank_args(work, state, dev, 4), taps, dev,
                            n_split=32, threads=t)[0]
            for t in ((128, 256, 512) if len(taps) == 3 else (128, 256))}
        r["all_equal_to_default"] = equal
        res[name] = r
    res["empty_launch_us"] = 1e3 * cs.timed_graph_ms(
        lambda: cb.empty_launch(dev), 10)
    return res


def cluster_reduction(work: dict, state, dev, base: dict) -> dict:
    """The prepared bank with a cluster per channel, by parts per channel
    (a cluster's size)."""
    res = {"equal_to_as_is": True}
    for name, taps in (("3taps", cs.VTParams().taps),
                       ("29taps", cs.VTParams.multicorr().taps)):
        args = bank_args(work, state, dev)
        res[name] = {}
        for k in (2, 4, 8):
            res[name][str(k)], out = bank_us(args, taps, dev, n_split=k)
            res["equal_to_as_is"] &= bool(
                torch.equal(out, base[f"bank_{name}"]))
    return res


def measure(work: dict, dev, cluster=None) -> dict:
    chips = work["chips"]
    out, res = {}, {}
    for kind, n_steps in (("epl", 1000), ("pos_multicorr", 300)):
        raw, start, state, spec = cs.chunk_of(work, kind, n_steps, dev)

        def run():
            return tc._track_chunk_cuda(raw, start, state, chips, spec,
                                        n_steps, cluster=cluster)

        out[kind], end = run()
        res[f"track_chunk_{kind}_{n_steps}_ms"] = cs.timed_ms(run, 5)
        if kind == "epl":
            _, early = tc._track_chunk_cuda(raw, start, state, chips, spec,
                                            cs.SCAN_LEAD_MS, cluster=cluster)
    flag = cb.new_fault(dev)
    for pdi in (1, 10):
        args = windows_args(work, early, pdi, dev)
        # prepared once, as track_scan does
        plan = cb.WindowsPlan(args[6], args[7], cs.FS, args[0].shape[1],
                              fault=flag)
        call = tuple(t.contiguous() for t in args[:6])
        out[f"win{pdi}"] = plan(*call)
        res[f"windows_bank_{pdi}ms_us"] = 1e3 * cs.timed_graph_ms(
            lambda: plan(*call), 10)
    for name, taps in (("3taps", cs.VTParams().taps),
                       ("29taps", cs.VTParams.multicorr().taps)):
        res[f"bank_{name}_us"], out[f"bank_{name}"] = bank_us(
            bank_args(work, early, dev), taps, dev)
    return res, out, early


def section_clocks(work: dict, dev) -> dict:
    """Mean cycles per block of each section, blocks 100 on, channel 0."""
    names = {"code_err": "block_length_and_nco_words", "carr_err": "r_phasors",
             "code_freq": "tile_wait_and_samples", "carr_freq": "cta_tap_sum",
             "rem_chip": "exchange_and_cluster_barrier",
             "rem_phase": None, "absolute_sample": "records_and_loop"}
    res = {}
    for kind, n_steps in (("epl", 1000), ("pos_multicorr", 300)):
        raw, start, state, spec = cs.chunk_of(work, kind, n_steps, dev)
        rec, _ = tc._track_chunk_cuda(raw, start, state, work["chips"], spec,
                                      n_steps)
        res[kind] = {label: float(rec[f][100:, 0].double().mean())
                     for f, label in names.items() if label}
    return res


def bank_section_clocks(work: dict, state, dev) -> dict:
    """Mean cycles of each section of a correlating CTA, one launch."""
    res = {}
    for name, taps in (("3taps", cs.VTParams().taps),
                       ("29taps", cs.VTParams.multicorr().taps)):
        raw, chips, words, blk = bank_args(work, state, dev)
        plan = cb.BankPlan(raw, chips, cb.tap_offsets_fp(taps, dev), cs.FS,
                           blk)
        for _ in range(3):
            plan(*words)
        torch.cuda.synchronize()
        slots = plan._call.partial.reshape(len(chips), -1,
                                           2 * (len(taps) + 1))
        res[name] = dict(zip(
            ("shares_copies_started_and_r_phasors", "tile_wait_and_samples",
             "cta_tap_sum", "slot_ticket_and_last_sum"),
            slots[:, :, :4].mean(dim=(0, 1)).tolist()))
    return res


def same(a, b) -> bool:
    if isinstance(a, dict):
        return not cs.differing_fields(a, b)
    return bool(torch.equal(a, b))


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_ablation: no CUDA device; this run needs a GPU",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0], flush=True)
    sources = {name: make_sources(name) for name in VARIANTS}
    with ThreadPoolExecutor(len(sources) * 2) as pool:
        jobs = {(name, lib): pool.submit(compile_one, d, lib)
                for name, d in sources.items()
                for lib in ("track_chunk", "corr_bank")}
        libs = {name: {lib: jobs[(name, lib)].result()
                       for lib in ("track_chunk", "corr_bank")}
                for name in sources}
    work = cs.kernel_workload(dev)
    base = None
    for name in VARIANTS:
        use_libraries(libs[name])
        if name == "section_clocks":
            print(json.dumps({"variant": name, **section_clocks(work, dev)}),
                  flush=True)
            continue
        if name == "cluster_reduction":
            print(json.dumps({"variant": name, **cluster_reduction(
                work, early, dev, base)}), flush=True)
            continue
        if name == "bank_section_clocks":
            print(json.dumps({"variant": name, **bank_section_clocks(
                work, early, dev)}), flush=True)
            continue
        res, out, early = measure(work, dev)
        if base is None:
            base = out
        res["equal_to_as_is"] = all(same(out[k], base[k]) for k in out)
        print(json.dumps({"variant": name, **res}), flush=True)
        if name == "as_is":
            print(json.dumps({"variant": "bank_design",
                              **bank_design(work, early, dev)}), flush=True)
            res, out, _ = measure(work, dev, cluster=1)
            res["equal_to_as_is"] = all(same(out[k], base[k]) for k in out)
            print(json.dumps({"variant": "one_cta_per_channel", **res}),
                  flush=True)
    # the same build again: how far two readings of one build differ
    use_libraries(libs["as_is"])
    res, _, _ = measure(work, dev)
    print(json.dumps({"variant": "as_is_again", **res}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
