"""The harness: one run of one cell of `BENCHMARK.json`.

Everything here is general.  A cell names a configuration (a JSON file
under `configs/`, named by `BENCHMARK.json`), a traffic mix (`traffic/
<name>.json`: the set-up stages, the pass, the kind of output, the
tracker, the correctness limits) and, through the manifest, the metrics
it reports (`metrics/<name>.py`, each with `read(ctx)`).  The kind of
output is a module of its own (`outputs/<kind>.py`) that keeps, judges
and counts a pass of that kind.  A later cell, mix, output kind or metric
is a new file and a new entry; nothing here names one.

A run: synthesize the capture on the card from the seed (host memory,
never disk), build the Receiver, run the mix's set-up stages, warm up with
one whole pass, then run passes back to back until `--seconds` have gone
by; the window closes at the end of the pass that crosses it.  With
`--trace 1` the window is one untraced pass, timed, then one pass under
the profiler.  Every pass starts from the set-up state: a new Receiver
over the set-up's artifacts, with whatever an earlier pass wrote deleted.  Once the window has closed the
memory peak is read, the program's state is let go, and the reference
judges every pass (`judge.py`, `reference.py`).
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from types import SimpleNamespace
from typing import Dict, List, Optional

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "gps_sdr_tpu")


class NoCard(RuntimeError):
    """The run found no CUDA card, or fewer than the cell asks for."""


class Forbidden(RuntimeError):
    """A module the benchmark may not load was loaded."""


# ---------------------------------------------------------------- manifest


def manifest(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def by_name(entries: List[dict], name: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no entry named {name!r}")


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_metrics(man: dict, workload: str, trace: bool) -> List[dict]:
    """The metrics the cell reports: with `trace` its per-layer ones (those
    listing it, or, without a list, those whose `moves` it reports), else
    its end-to-end ones."""
    e2e = [m for m in man["end_to_end"]
           if workload in m.get("workloads", [workload])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in man["per_layer"]
            if (workload in m["workloads"] if "workloads" in m
                else m["moves"] in names)]


def _load(path: str, module: str):
    spec = importlib.util.spec_from_file_location(module, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_reader(name: str, root: str = ROOT):
    """`metrics/<name>.py`'s `read`."""
    return _load(os.path.join(root, "sdrbench", "metrics", name + ".py"),
                 "sdrbench_metric_" + name.replace(".", "_")).read


def load_output(kind: str, root: str = ROOT):
    """`outputs/<kind>.py`: the module that keeps a pass's result of that
    kind (`keep`), judges it (`judge`), counts what it covered
    (`covered_samples`, `steps`) and the kernel launches it made
    (`launches`)."""
    path = os.path.join(root, "sdrbench", "outputs", kind + ".py")
    if not os.path.isfile(path):
        raise ValueError(f"unknown output kind {kind!r}: no file {path}")
    return _load(path, "sdrbench_output_" + kind.replace(".", "_"))


def merged(base: dict, over: Optional[dict]) -> dict:
    """`base` with the groups of `over` merged in, key by key."""
    out = json.loads(json.dumps(base))
    for k, v in (over or {}).items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = merged(out[k], v)
        else:
            out[k] = v
    return out


def port_config(cfg: dict):
    """The program's `ReceiverConfig` of a configuration file's `receiver`
    group (lists become the dataclasses' tuples)."""
    from gps_sdr_tpu_torch import config as C
    r = cfg["receiver"]

    def grp(cls, d):
        return cls(**{k: tuple(v) if isinstance(v, list) else v
                      for k, v in d.items()})
    return C.ReceiverConfig(
        file=grp(C.FileConfig, r["file"]), signal=grp(C.SignalConfig,
                                                      r["signal"]),
        acq=grp(C.AcqConfig, r["acq"]), track=grp(C.TrackConfig, r["track"]),
        solu=grp(C.SolutionConfig, r["solu"]),
        cmn=grp(C.CommonConfig, r["cmn"]))


# ---------------------------------------------------------------- device


def card(chips: int):
    import torch
    if not torch.cuda.is_available():
        raise NoCard("no CUDA device: this benchmark runs on a card only")
    if torch.cuda.device_count() < chips:
        raise NoCard(f"the cell asks for {chips} cards, "
                     f"{torch.cuda.device_count()} found")
    return torch.device("cuda", 0)


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def power_limit() -> Optional[str]:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return res.stdout.strip().splitlines()[0] if res.stdout else None
    except (OSError, subprocess.SubprocessError):
        return None


# ---------------------------------------------------------------- run


class Run:
    """One run of one cell, in steps: `setup` (the capture, the mix's
    set-up stages, a warm-up pass), `window` (passes back to back, or one
    traced), `close` (the memory peak, the program's state let go), `judge`
    (the reference over the window's passes) and `line`.  `run_cell` takes
    them in that order; a test may run several windows over one set-up.

    `device` None is the card (or NoCard); the tests give "cpu".
    `overrides` merges into the configuration and the mix (keys "config",
    "mix"), for runs at a small size on the CPU."""

    def __init__(self, workload: str, seed: int, device=None,
                 overrides: Optional[dict] = None, root: str = ROOT):
        import torch
        self.root, self.workload, self.seed = root, workload, seed
        self.man = manifest(root)
        self.cell = by_name(self.man["workloads"], workload)
        conf = by_name(self.man["configs"], self.cell["config"])
        self.cfg = merged(load_json(os.path.join(root, conf["file"])),
                          (overrides or {}).get("config"))
        self.mix = merged(load_json(os.path.join(
            root, "sdrbench", "traffic", self.cell["traffic"] + ".json")),
            (overrides or {}).get("mix"))
        self.output = load_output(self.mix["output"], root)
        self.dev = (card(self.cell["chips"]) if device is None
                    else torch.device(device))
        self.cuda = self.dev.type == "cuda"
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.parts: Dict[str, float] = {}
        self.work = None

    def setup(self, t_start: float) -> float:
        """Everything before the first timed pass; returns setup_s."""
        import torch
        from sdrbench import sky
        from gps_sdr_tpu_torch.io.ifdata import IFSampleSource
        from gps_sdr_tpu_torch.pipeline import Receiver

        mix, dev = self.mix, self.dev
        self.pcfg = port_config(self.cfg)
        self.parts["import_s"] = time.perf_counter() - t_start
        t = time.perf_counter()
        self.values, self.gs = sky.make_capture(self.cfg, self.seed, dev)
        self.parts["capture_s"] = time.perf_counter() - t
        self.src = IFSampleSource.from_array(self.values, self.pcfg.file)
        if self.cuda:
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        self.work = tempfile.mkdtemp(prefix="sdrbench-")
        rx = Receiver(self.pcfg, self.src, artifact_dir=self.work,
                      device=dev, mesh=None)
        for stage, kw in mix["setup"]:
            t = time.perf_counter()
            getattr(rx, stage)(**kw)
            self.parts[stage + "_s"] = time.perf_counter() - t
        acq = rx.acquisition()
        self.prns = ([int(p) for p in acq.sv]
                     if mix["channels"] == "acquired"
                     else [int(p) for p in rx.usable_svs()])
        self.acq = dict(sv=np.asarray(acq.sv),
                        code_delay=np.asarray(acq.code_delay),
                        fine_freq_hz=np.asarray(acq.fine_freq_hz))
        del rx
        self.base = set(os.listdir(self.work))
        t = time.perf_counter()
        self.one_pass()                              # warm-up
        self.parts["warm_pass_s"] = time.perf_counter() - t
        self.setup_s = time.perf_counter() - t_start
        return self.setup_s

    def one_pass(self) -> Dict[str, np.ndarray]:
        """The mix's pass from the set-up state: a new Receiver over the
        set-up's artifacts, whatever an earlier pass wrote deleted."""
        import torch
        from gps_sdr_tpu_torch.pipeline import Receiver
        for f in os.listdir(self.work):
            if f not in self.base:
                os.remove(os.path.join(self.work, f))
        entry, kwargs = self.mix["pass"]
        r = Receiver(self.pcfg, self.src, artifact_dir=self.work,
                     device=self.dev, mesh=None)
        out = getattr(r, entry)(**kwargs)
        if self.cuda:
            torch.cuda.synchronize(self.dev)
        return self.output.keep(out)

    def window(self, seconds: float, trace: bool) -> None:
        """Passes back to back until `seconds` have gone by (the window
        closes at the end of the pass that crosses it), or with `trace`
        one untraced pass, timed (`untraced`), then one pass under the
        profiler (`passes`).  The reference judges both."""
        self.passes, self.walls, self.trace = [], [], None
        self.untraced, self.untraced_s = [], None
        if trace:
            from sdrbench.trace import traced
            a = time.perf_counter()
            self.untraced = [self.one_pass()]
            self.untraced_s = time.perf_counter() - a
            rec, self.trace = traced(self.one_pass, self.dev)
            self.passes, self.walls = [rec], [self.untraced_s,
                                              self.trace.window_s]
            self.window_s = self.trace.window_s
            return
        t0 = time.perf_counter()
        while True:
            a = time.perf_counter()
            self.passes.append(self.one_pass())
            b = time.perf_counter()
            self.walls.append(b - a)
            if b - t0 >= seconds:
                break
        self.window_s = time.perf_counter() - t0

    def close(self) -> None:
        """Read the memory peak, let the program's state go, and refuse a
        process that holds a module of JAX or of the JAX package."""
        import torch
        self.peak = (int(torch.cuda.max_memory_allocated(self.dev))
                     if self.cuda else 0)
        if self.work:
            shutil.rmtree(self.work, ignore_errors=True)
            self.work = None
        bad = forbidden_modules()
        if bad:
            raise Forbidden("modules loaded in this process: "
                            + ", ".join(bad))
        gc.collect()
        if self.cuda:
            torch.cuda.empty_cache()

    def judge(self, dtype=np.float64) -> List[dict]:
        """The reference's gaps: the start, then each pass of the window
        (with `dtype` float32, the control's)."""
        from sdrbench import judge, sky
        from sdrbench.frozen.cacode import ca_code
        if not hasattr(self, "case"):
            codes = np.stack([ca_code(p) for p in self.prns]
                             ).astype(np.float64)
            ephs = {sv.prn: sv.eph for sv in self.gs.svs}
            self.case = judge.Case(
                self.cfg, self.mix, self.values.reshape(-1, 2), codes,
                self.acq, sky.truth_chips(self.gs, self.cfg["capture_ms"]),
                self.dev, ephs=[ephs[p] for p in self.prns])
        rng = np.random.default_rng(self.seed)
        judged = self.untraced + self.passes
        per_pass = max(1, self.mix["check_blocks"] // len(judged))
        gaps = self.output.judge(self.case, judged, rng, per_pass, dtype)
        if dtype == np.float64:
            gaps.insert(0, judge.judge_start(self.case,
                                             self.cfg["sky"]["prns"]))
        return [g.v for g in gaps]

    def verdict(self, gaps: List[dict]) -> dict:
        from sdrbench import judge
        return judge.verdict(gaps, self.mix["limits"])

    def line(self, gaps: List[dict], judge_s: float) -> dict:
        """The result line: `correct` from the gaps, the cell's metrics
        (per-layer ones for a traced window), the device, the checks."""
        import torch
        from sdrbench import launches
        v = self.verdict(gaps)
        out = self.output
        ctx = SimpleNamespace(
            setup_s=self.setup_s, window_s=self.window_s,
            passes=self.passes, trace=self.trace, cfg=self.cfg,
            mix=self.mix, case=self.case, output=out,
            covered_s=sum(out.covered_samples(r, self.case.init["ptr"])
                          for r in self.passes) / self.case.fs,
            steps=sum(out.steps(r) for r in self.passes),
            untraced_s=self.untraced_s, sample_bytes=self.values.itemsize)
        # each launch's bound, by kernel, worked out once for the readers
        ctx.launches = (out.launches(ctx, self.passes[0])
                        if self.trace is not None else {})
        metrics = {}
        for m in cell_metrics(self.man, self.workload,
                              self.trace is not None):
            val = load_reader(m["name"], self.root)(ctx)
            if val is not None:
                metrics[m["name"]] = {"value": float(val), "unit": m["unit"]}
        dev = {"platform": "gpu" if self.cuda else self.dev.type,
               "kind": (torch.cuda.get_device_name(self.dev) if self.cuda
                        else "cpu"),
               "count": self.cell["chips"] if self.cuda else 0,
               "memory_peak_bytes": self.peak}
        line = {"correct": all(v["ok"]),
                "attempted": len(self.untraced) + len(self.passes),
                "failed": sum(not ok for ok in v["ok"]), "metrics": metrics,
                "device": dev}
        if self.trace is not None:
            dev["busy_s"] = self.trace.busy_s()
            dev["window_s"] = self.trace.window_s
            line["breakdown"] = {"device_ops": self.trace.device_ops(),
                                 "idle_gaps": self.trace.idle_gaps()}
            line["bound_by"] = {
                w: launches.bound_by(ctx, w) for w in ("b1", "b2", "b3")
                if w + ".roofline_pct" in metrics}
        if self.cuda:
            line["card"] = power_limit()
        line["pass_s"] = self.walls
        line["setup_parts"] = self.parts
        line["judge_s"] = judge_s
        line["checks"] = v["numbers"]
        return line


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             t_start: float, device=None, overrides: Optional[dict] = None,
             control: bool = False, root: str = ROOT) -> dict:
    """One run of `workload`.  Returns {"line": the result line's dict,
    "checks": [stderr lines], "gaps": the reference's gaps (the start,
    then each pass), and with `control` "control_gaps": the same passes
    judged against the control}."""
    run = Run(workload, seed, device, overrides, root)
    try:
        run.setup(t_start)
        run.window(seconds, trace)
    finally:
        run.close()
    t = time.perf_counter()
    gaps = run.judge()
    judge_s = time.perf_counter() - t
    line = run.line(gaps, judge_s)
    checks = [f"check {n} {val!r} limit {lim!r}"
              for n, (val, lim) in line["checks"].items()]
    control_gaps = run.judge(np.float32) if control else None
    bad = forbidden_modules()
    if bad:
        raise Forbidden("modules loaded in this process: " + ", ".join(bad))
    return dict(line=line, checks=checks, gaps=gaps,
                control_gaps=control_gaps)
