#!/usr/bin/env python3
"""What each part of the kernels' design is worth on the card.

    python3 kernel_ablation.py

Builds the kernels as they are, and once more for each variant below: a
scratch copy of gps_sdr_tpu_torch/csrc/ under build/ablation/ with one part
of the design taken out again (the tree's sources are not touched).  Every
build is timed on chip_smoke.py's phase-2 workload (58 MHz int8, 8
channels): track_chunk over 1000 E/P/L blocks and over 300 blocks of the
25-tap bank (CUDA events over the wrapper call), correlator_bank_windows at
1 ms and 10 ms, 3 taps (device time per launch from a replayed CUDA graph).
One JSON line per variant; the variants differ from `as_is` only in time
(`equal_to_as_is` says so), except `no_samples`, which correlates nothing
and shows what a block costs beside its samples.

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
Last, `section_clocks`: track_chunk with clock64() read between the sections
of a block and written into the records in place of their values; the line
gives each section's mean cycles per block on rank 0 of channel 0.
"""

from __future__ import annotations

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
        out[f"win{pdi}"], _ = cb.correlator_bank_windows(*args)
        res[f"windows_bank_{pdi}ms_us"] = 1e3 * cs.timed_graph_ms(
            lambda: cb.correlator_bank_windows(*args, fault=flag), 10)
    return res, out


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
        res, out = measure(work, dev)
        if base is None:
            base = out
        res["equal_to_as_is"] = all(same(out[k], base[k]) for k in out)
        print(json.dumps({"variant": name, **res}), flush=True)
        if name == "as_is":
            res, out = measure(work, dev, cluster=1)
            res["equal_to_as_is"] = all(same(out[k], base[k]) for k in out)
            print(json.dumps({"variant": "one_cta_per_channel", **res}),
                  flush=True)
    # the same build again: how far two readings of one build differ
    use_libraries(libs["as_is"])
    res, _ = measure(work, dev)
    print(json.dumps({"variant": "as_is_again", **res}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
