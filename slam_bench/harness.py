"""One run of one cell: set-up, the measured window, the traced part, the
check, and the result line.

A cell (an entry of BENCHMARK.json's `workloads`) names a configuration,
`configs/<name>.json`, and a traffic mix, `traffic/<name>.json`; every
metric is read by `metrics/<name>.py`, and the check's limits of a cell
are `limits/<cell>.json`. Nothing here names a cell, a configuration, a
mix or a metric: a new one is a new file and a new entry.

Set-up renders the mix's scene along its path once: two seed frames, the
`prefix_frames` of the sequence before the episode, and the episode's
frames. It builds the program's SLAMSystem from the configuration, seeds
it with two keyframes from the two seed frames, and hands it the prefix,
noiseless, on the mix's own path (`frames_per_call` per `process_batch`
call), so that the map at the episode's start holds what a sequence's
worth of frames leaves in it: the same state for every seed. That state is
snapshotted. The mix's `takes` copies of the episode's frames are made on
the card, each with its own sensor noise, the same copies for every seed;
the seed draws the order in which they play. Each episode restores the
snapshot and hands the system one take's frames, the next call made when
the last one returns (a closed loop); episode n plays the seed's take n
modulo the takes. The
prefix runs the very path the episodes run, so every kernel and shape is
built before the window; the window then runs whole rounds of the takes
until `seconds` have passed, ending with the round that crosses that
mark, so that every seed's window does the same work (the first episode
is the one the check reads). With `trace` the window runs
with host clocks around the program's chunk, its keyframe integration and
its local-mapping stages, and counts of local mapping's neighbours and
bundle-adjustment cameras; after the window one episode runs plain and
the same one under torch.profiler, which records the card's work alone.
Without `trace`, on a card, the whole window runs under that profiler,
for the card's busy time over the window.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from slam_bench import check, seeding
from slam_bench.scene import TRAJECTORIES, SyntheticScene
from slam_bench.trace import device_events, from_events

ROOT = Path(__file__).resolve().parent
BENCHMARK_JSON = ROOT.parent / "BENCHMARK.json"
# top-level module names no process of the benchmark may hold
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "orb_slam_tpu")


def sync():
    """Wait for the card, where there is one (the CPU rehearsals of the
    tests have none)."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()


class NoCard(RuntimeError):
    """The run needs CUDA cards that are not there."""


def process_start_time() -> float:
    """time.time() at which this process started (from /proc), or now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            boot = next(int(l.split()[1]) for l in f if l.startswith("btime"))
        return boot + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, StopIteration, IndexError):
        return time.time()


def forbidden_modules(modules=None):
    """Loaded modules whose top-level name is one of FORBIDDEN_MODULES,
    compared whole (`orb_slam_tpu_torch` is not `orb_slam_tpu`)."""
    modules = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in modules}
                  & set(FORBIDDEN_MODULES))


def load_json(root: Path, kind: str, name: str) -> dict:
    with open(root / kind / f"{name}.json") as f:
        return json.load(f)


def reader(root: Path, metric: str):
    """The `read(readings)` function of metrics/<metric>.py."""
    path = root / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"slam_bench_metric_{metric.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(bench: dict, cell: str):
    """(end-to-end metric entries, per-layer metric entries) the cell
    reports: those that list it under `workloads`, or have no
    `workloads` (per-layer: and move an end-to-end metric it reports)."""
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    names = {m["name"] for m in e2e}
    per = [m for m in bench["per_layer"]
           if cell in m.get("workloads", [cell] if m["moves"] in names else [])]
    return e2e, per


def card_line() -> str:
    """nvidia-smi's name and power limit of the first card."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return f"{torch.cuda.get_device_name(0)}, power limit not read"


# ----------------------------------------------------------------- set-up

def slam_config(config: dict):
    """The program's SlamConfig from a configuration file: the settings
    through the program's own settings reader, the map and the solver
    sizes from `slam`."""
    from orb_slam_tpu_torch.io.settings import slam_config_from_settings
    from orb_slam_tpu_torch.pipeline.system import SlamConfig
    from orb_slam_tpu_torch.slam_map.map_state import MapConfig

    text = "%YAML:1.0\n" + "".join(f"{k}: {v}\n" for k, v in config["settings"].items())
    with tempfile.NamedTemporaryFile("w", suffix=".yaml") as f:
        f.write(text)
        f.flush()
        cam, orb, extras = slam_config_from_settings(f.name)
    sl = config["slam"]
    mp = MapConfig(max_keyframes=sl["max_keyframes"], max_points=sl["max_points"],
                   n_features=orb.n_features, n_levels=orb.n_levels,
                   scale_factor=orb.scale_factor)
    return SlamConfig(camera=cam, orb=orb, map=mp, max_ba_cams=sl["max_ba_cams"],
                      max_ba_points=sl["max_ba_points"],
                      track_chunk_size=sl["track_chunk_size"],
                      min_track_inliers=sl["min_track_inliers"],
                      use_motion_model=extras["use_motion_model"])


def reference_numbers(config: dict) -> dict:
    """What the references are built from, read from the configuration
    file itself and not from the program."""
    st = config["settings"]
    return dict(K=[[st["Camera.fx"], 0.0, st["Camera.cx"]],
                   [0.0, st["Camera.fy"], st["Camera.cy"]], [0.0, 0.0, 1.0]],
                n_features=st["ORBextractor.nFeatures"],
                n_levels=st["ORBextractor.nLevels"],
                scale_factor=st["ORBextractor.scaleFactor"],
                fast_th=st["ORBextractor.fastTh"],
                score_harris=st["ORBextractor.nScoreType"] == 0,
                width=st["Camera.width"], height=st["Camera.height"],
                dist=[st.get(k, 0.0) for k in ("Camera.k1", "Camera.k2",
                                               "Camera.p1", "Camera.p2")],
                min_inliers=config["slam"]["min_track_inliers"])


def scene_frames(config: dict, traffic: dict):
    """(scene, ground-truth poses [2 + prefix + n, 4, 4], noiseless frames
    [2 + prefix + n, H, W] numpy): two seed frames, the prefix, then the
    episode's frames, the same for every seed. The mix's `scene` keys but
    `noise` are the scene's fields (`layout` "box" or "street"), and its
    `trajectory` keys but `kind` ("lateral" or "forward") are the path's
    arguments; a missing key takes the scene's or the path's default."""
    st = config["settings"]
    sc = {k: v for k, v in traffic["scene"].items() if k != "noise"}
    scene = SyntheticScene(
        width=st["Camera.width"], height=st["Camera.height"],
        fx=st["Camera.fx"], fy=st["Camera.fy"], cx=st["Camera.cx"], cy=st["Camera.cy"],
        dist=tuple(st.get(k, 0.0) for k in ("Camera.k1", "Camera.k2",
                                             "Camera.p1", "Camera.p2")), **sc)
    tr = dict(traffic["trajectory"])
    kind = tr.pop("kind", "lateral")
    if kind not in TRAJECTORIES:
        raise ValueError(f"unknown trajectory kind {kind!r}")
    n = 2 + traffic.get("prefix_frames", 0) + traffic["episode_frames"]
    poses = TRAJECTORIES[kind](n, **tr)
    return scene, poses, np.stack([scene.render_image(p) for p in poses])


def noisy(clean: torch.Tensor, sigma: float, count: int):
    """`count` takes of the frames [n, H, W] on their device, each with
    Gaussian sensor noise of standard deviation `sigma` from a generator
    on the device seeded by the take's index, clipped to [0, 255]: the
    same takes for every seed."""
    out = []
    for k in range(count):
        gen = torch.Generator(device=clean.device)
        gen.manual_seed(k)
        noise = torch.randn(clean.shape, generator=gen, device=clean.device)
        out.append(torch.clamp(clean + sigma * noise, 0.0, 255.0))
    return out


def take_order(seed: int, count: int) -> list:
    """The order in which a seed plays the `count` takes: a permutation
    drawn from the seed."""
    return np.random.default_rng(seed).permutation(count).tolist()


# ------------------------------------------------------------------ hooks

def wrap(s, name: str, make):
    """Install make(current method) as `s.<name>` (an instance attribute).
    Returns what `unwrap` needs to put the previous one back."""
    prev = s.__dict__.get(name)
    setattr(s, name, make(getattr(s, name)))
    return name, prev


def unwrap(s, tokens):
    """Undo `wrap`s, the last first."""
    for name, prev in reversed(tokens):
        if prev is None:
            s.__dict__.pop(name, None)
        else:
            s.__dict__[name] = prev


class _RecordingExtractor:
    """The program's extractor, recording each result by the episode frame
    index it was called for."""

    def __init__(self, inner, s, capture):
        self.inner, self.s, self.capture = inner, s, capture
        self.config = inner.config
        self.k = None          # position within the chunk being extracted

    def __call__(self, img):
        f = self.inner(img)
        i = self.s.frame_id - self.capture.base + (self.k or 0)
        if self.k is not None:
            self.k += 1
        self.capture.features[i] = dict(xy=f.xy, angle=f.angle, octave=f.octave,
                                        desc=f.desc_i32, valid=f.valid)
        return f


def install_capture(s, capture):
    """Record what the program produces (check.Capture), by frame index
    from `capture.base`. Holds references to the program's tensors and
    adds no device work."""
    rec = _RecordingExtractor(s.extractor, s, capture)
    s.extractor = rec

    def chunk(orig):
        def f(images):
            rec.k = 0
            try:
                return orig(images)
            finally:
                rec.k = None
        return f

    def apply_chunk(orig):
        def f(feats, xy_und, res, n, ts_list):
            base, m = s.frame_id - capture.base, s.map
            for b in range(n):
                capture.tracked[base + b] = dict(
                    pose=res.pose[b], obs=res.obs[b], map=m,
                    n_in=res.n_inliers[b])
            return orig(feats, xy_und, res, n, ts_list)
        return f

    def track(orig):
        def f(frame):
            m = s.map
            T = orig(frame)
            prev = s._prev_frame
            if T is not None and prev is not None and prev[0] is frame:
                capture.tracked[frame.frame_id - capture.base] = dict(
                    pose=T, obs=prev[1], map=m, n_in=None)
            return T
        return f

    def integrate(orig):
        def f(frame, obs, n_in, pose=None, abort=None):
            slot = orig(frame, obs, n_in, pose, abort)
            m = s.map
            capture.integrations.append(dict(
                slot=slot, kf_pose=m.kf_pose, kf_valid=m.kf_valid, kf_obs=m.kf_obs,
                kf_xy=m.kf_xy, kf_octave=m.kf_octave, pt_pos=m.pt_pos,
                pt_valid=m.pt_valid))
            return slot
        return f

    rec.tokens = [wrap(s, name, make) for name, make in (
        ("_chunk_extract_track", chunk), ("_apply_chunk", apply_chunk),
        ("_track", track), ("_integrate_keyframe", integrate))]
    return rec


def remove_capture(s, rec):
    s.extractor = rec.inner
    unwrap(s, rec.tokens)


def install_timers(s, spans: dict):
    """Host clocks, the card synchronized at both ends, around the
    program's chunk (with the frames it handled) and its keyframe
    integration, and the program's own stage hook on every local-mapping
    stage. The times land in `spans`."""
    from orb_slam_tpu_torch.utils.timing import StageTimer

    spans.update(chunk_s=[], chunk_frames=[], integrate_s=[], stages={})

    def timed(key, frames_key=None):
        def make(orig):
            def f(*args, **kw):
                sync()
                t = time.perf_counter()
                out = orig(*args, **kw)
                sync()
                spans[key].append(time.perf_counter() - t)
                if frames_key:
                    spans[frames_key].append(len(args[0]))
                return out
            return f
        return make

    s._stage_timer = StageTimer(times=spans["stages"])
    return [wrap(s, "_chunk_extract_track", timed("chunk_s", "chunk_frames")),
            wrap(s, "_integrate_keyframe", timed("integrate_s"))]


def install_counters(s, spans: dict):
    """Counts, per keyframe integration, of what local mapping works on:
    the covisible neighbours of the new keyframe (fuse and triangulation
    take the first 20), and local BA's cameras (optimised, and all that
    observe its points), points and the map's live keyframes. Reads the
    program's own sets; the camera count waits for the card."""
    spans.update(neighbors=[], ba_cams=[], ba_opt_cams=[], ba_points=[],
                 live_kfs=[])

    def neighbors(orig):
        def f(m, kf):
            out = orig(m, kf)
            spans["neighbors"].append(len(out[2]))
            spans["live_kfs"].append(int(out[1].sum()))
            return out
        return f

    def ba_sets(orig):
        def f(m, new_kf, nbrs):
            cam_opt, pt_opt = orig(m, new_kf, nbrs)
            obs = m.kf_obs
            sees = ((obs >= 0) & pt_opt[obs.clamp(min=0).long()]).any(1)
            spans["ba_cams"].append(int((m.kf_valid & (sees | cam_opt)).sum()))
            spans["ba_opt_cams"].append(int(cam_opt.sum()))
            spans["ba_points"].append(int(pt_opt.sum()))
            return cam_opt, pt_opt
        return f

    return [wrap(s, "_covisible_neighbors", neighbors),
            wrap(s, "_local_ba_sets", ba_sets)]


def install_labels(s, labels: list):
    """Host-clock ranges (name, start, end in perf_counter seconds) around
    the program's chunk, a single frame's extraction and tracking, and
    keyframe integration, appended to `labels`."""
    def labelled(label):
        def make(orig):
            def f(*args, **kw):
                t = time.perf_counter()
                try:
                    return orig(*args, **kw)
                finally:
                    labels.append((label, t, time.perf_counter()))
            return f
        return make

    return [wrap(s, name, labelled(label)) for name, label in (
        ("_chunk_extract_track", "chunk"), ("make_frame", "extract"),
        ("_track", "track"), ("_integrate_keyframe", "integrate"))]


# ----------------------------------------------------------------- window

def episode(s, snap, frames, per_call, on_call=None, labels=None):
    """Restore the snapshot and hand the system the episode's frames,
    `per_call` at a time. on_call(n frames, seconds, poses) after each
    call. With `labels` the restore's host-clock range is appended there."""
    t = time.perf_counter()
    seeding.restore(s, snap)
    if labels is not None:
        labels.append(("restore", t, time.perf_counter()))
    for i in range(0, len(frames), per_call):
        batch = frames[i:i + per_call]
        t = time.perf_counter()
        poses = s.process_batch(batch, chunk_size=per_call)
        dt = time.perf_counter() - t
        if on_call is not None:
            on_call(len(batch), dt, poses)


def measure(s, snap, takes, per_call, seconds, capture=None):
    """The window: whole rounds of episodes, each round every take once in
    the seed's order (episode n on take n modulo the takes), until
    `seconds` have passed; it ends with the round that crosses that mark,
    so every seed's window holds the same work. Returns (host clock at its
    start, window seconds, latency of each frame handed over, frames
    without a pose, episodes run). The first episode records into
    `capture`."""
    lat, failed = [], [0]
    sync()
    t0 = time.perf_counter()
    end = t0 + seconds
    n_ep = 0

    def on_call(n, dt, poses):
        lat.extend([dt] * n)
        failed[0] += sum(p is None for p in poses)

    while n_ep % len(takes) or time.perf_counter() < end:
        rec = install_capture(s, capture) if (capture is not None and n_ep == 0) else None
        try:
            episode(s, snap, takes[n_ep % len(takes)], per_call, on_call)
        finally:
            if rec is not None:
                remove_capture(s, rec)
        n_ep += 1
    sync()
    return t0, time.perf_counter() - t0, lat, failed[0], n_ep


def start_card_profile():
    """(A started torch.profiler that records the card's work alone, the
    host time at which its marker kernel was launched on the idle card)."""
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CUDA])
    prof.start()
    sync()
    t_mark = time.perf_counter()
    torch.cuda._sleep(1000)
    return prof, t_mark


def stop_card_profile(prof, t_mark, span, labels=()):
    """Stop the profiler and reduce its events to a Trace over `span`
    (host clock), the host `labels` put on the trace's clock."""
    prof.stop()
    return from_events(device_events(prof), list(labels), span, t_mark)


def profile_episode(s, snap, frames, per_call):
    """(Trace, frames handed over, seconds under the profiler, seconds of
    the same episode run plain just before). The profiler records the
    card's work alone (kernels, copies, fills), so its cost on the host is
    small; the harness's own host-clock labels are put on the trace's
    clock by a marker kernel launched on the idle card at the start."""
    sync()
    t = time.perf_counter()
    episode(s, snap, frames, per_call)
    sync()
    plain_s = time.perf_counter() - t
    labels = []
    tokens = install_labels(s, labels)
    prof, t_mark = start_card_profile()
    try:
        episode(s, snap, frames, per_call, labels=labels)
        sync()
        t_end = time.perf_counter()
    finally:
        unwrap(s, tokens)
    tr = stop_card_profile(prof, t_mark, (t_mark, t_end), labels)
    return tr, len(frames), t_end - t_mark, plain_s


# -------------------------------------------------------------------- run

class Readings:
    """What the metric readers read: the cell's configuration and mix, the
    window's clocks and counts, and in a traced run the spans, the counts
    and the trace."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


class Cell:
    """A cell's files by name: its BENCHMARK.json entry, configuration,
    traffic mix, check limits and the metric entries it reports."""

    def __init__(self, name: str, bench: dict = None, root: Path = ROOT):
        if bench is None:
            with open(BENCHMARK_JSON) as f:
                bench = json.load(f)
        self.name, self.root = name, root
        self.entry = next(w for w in bench["workloads"] if w["name"] == name)
        self.config = load_json(root, "configs", self.entry["config"])
        self.traffic = load_json(root, "traffic", self.entry["traffic"])
        self.e2e, self.per_layer = cell_metrics(bench, name)

    def limits(self) -> dict:
        return load_json(self.root, "limits", self.name)


class Setup:
    """A cell's seed-independent state: the system at the episode's start
    and its snapshot, the episode's noiseless frames on the device, the
    ground truth the check reads (`truth`: scene, poses, and `base`, the
    frame index of the episode's first frame), and what the prefix left
    (`prefix`: counts per integration)."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def build(cell: Cell, device, log=None) -> Setup:
    """Seed the system with the two seed frames, hand it the prefix on the
    mix's path, and snapshot it. Raises where the prefix loses the
    camera: the episodes would start lost."""
    from orb_slam_tpu_torch.pipeline.system import SLAMSystem, WORKING

    scene, poses, clean = scene_frames(cell.config, cell.traffic)
    n_pre = cell.traffic.get("prefix_frames", 0)
    per_call = cell.traffic["frames_per_call"]
    s = SLAMSystem(slam_config(cell.config), device=device)
    seeding.start_working(s, scene, poses,
                          torch.from_numpy(clean[:2]).to(device))
    counts = {}
    tokens = install_counters(s, counts)
    t = time.perf_counter()
    for i in range(2, 2 + n_pre, per_call):
        batch = torch.from_numpy(clean[i:min(i + per_call, 2 + n_pre)]).to(device)
        s.process_batch(batch, chunk_size=per_call)
        if s.state != WORKING:
            raise RuntimeError(f"the prefix lost the camera at frame {s.frame_id}")
    sync()
    unwrap(s, tokens)
    if log is not None and n_pre:
        log(f"prefix: {n_pre} frames in {time.perf_counter() - t:.3f} s, "
            f"{len(counts['neighbors'])} integrations; per integration: "
            f"neighbours {counts['neighbors']}, BA cameras {counts['ba_cams']} "
            f"(optimised {counts['ba_opt_cams']}), BA points "
            f"{counts['ba_points']}, live keyframes {counts['live_kfs']}; "
            f"points {s.n_points}")
    base = s.frame_id
    truth = dict(scene=scene, poses=poses, base=base)
    episode_clean = torch.from_numpy(clean[base:]).to(device)
    return Setup(s=s, snap=seeding.snapshot(s), clean=episode_clean,
                 truth=truth, prefix=counts)


def takes_of(cell: Cell, setup: Setup, seed: int):
    """The mix's `takes` noisy copies of the episode's frames, the same
    for every seed, in the order the seed draws: every seed's window
    plays the same work in another order."""
    sc = cell.traffic
    takes = noisy(setup.clean, sc["scene"]["noise"], sc["takes"])
    return [takes[k] for k in take_order(seed, len(takes))]


def judge(cell: Cell, capture, frames, failed: int, device, truth: dict,
          control=False):
    """check.numbers of what the window produced (or, with `control`, of
    the reference one precision lower in the program's place)."""
    return check.numbers(capture, frames, failed, reference_numbers(cell.config),
                         device, truth, control=control)


def run(name: str, seed: int, seconds: float, trace: bool, *, bench: dict = None,
        root: Path = ROOT, device: str = "cuda", require_card: bool = True,
        limits: dict = None, log=print):
    """One run; returns the result dict (its keys in the printed order)."""
    t_start = process_start_time()
    cell = Cell(name, bench, root)
    limits = cell.limits() if limits is None else limits
    wanted = cell.per_layer if trace else cell.e2e
    readers = {m["name"]: reader(root, m["name"]) for m in wanted}
    if require_card and (not torch.cuda.is_available()
                         or torch.cuda.device_count() < cell.entry["chips"]):
        raise NoCard(f"{name} needs {cell.entry['chips']} CUDA card(s); "
                     f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} "
                     f"visible")
    card = card_line() if require_card else "no card"
    log(f"card: {card}")
    dev = torch.device(device)
    t = time.time()
    setup = build(cell, dev, log)
    takes = takes_of(cell, setup, seed)
    s, snap = setup.s, setup.snap
    per_call = cell.traffic["frames_per_call"]
    seeding.restore(s, snap)
    sync()
    # an untraced run on a card profiles its whole window for the card's
    # busy time; the profiler's start is set-up
    profiler = start_card_profile() if (not trace and dev.type == "cuda") else None
    setup_s = time.time() - t_start
    log(f"set-up {setup_s:.3f} s: start to scene {t - t_start:.3f} s, scene, "
        f"system, seeding, prefix, takes{' and profiler' if profiler else ''} "
        f"{time.time() - t:.3f} s")

    capture = check.Capture(base=setup.truth["base"])
    spans, timers = {}, []
    if trace:
        timers = install_timers(s, spans) + install_counters(s, spans)
    t0, window_s, lat, failed, n_ep = measure(s, snap, takes, per_call, seconds,
                                              capture)
    window_trace = None
    if profiler is not None:
        t = time.perf_counter()
        window_trace = stop_card_profile(*profiler, (t0, t0 + window_s))
        log(f"window: {len(lat)} frames in {window_s:.3f} s, {n_ep} episodes, "
            f"card busy {window_trace.busy_s():.4f} s; trace read in "
            f"{time.perf_counter() - t:.3f} s")
    else:
        log(f"window: {len(lat)} frames in {window_s:.3f} s, {n_ep} episodes")
    memory_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    tr, tr_frames = None, 0
    if trace:
        unwrap(s, timers)
        s._stage_timer = None
        if dev.type == "cuda":
            tr, tr_frames, traced_s, plain_s = profile_episode(s, snap, takes[0],
                                                               per_call)
            log(f"traced episode {traced_s:.3f} s against {plain_s:.3f} s plain "
                f"(x{traced_s / plain_s:.3f}); busy {tr.busy_s():.3f} s")
    r = Readings(config=cell.config, traffic=cell.traffic, cfg=s.cfg,
                 setup_s=setup_s, window_s=window_s, latencies=lat,
                 frames=len(lat), failed=failed, episodes=n_ep, spans=spans,
                 window_trace=window_trace, trace=tr, trace_frames=tr_frames)
    metrics = {}
    for m in wanted:
        v = readers[m["name"]](r)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    # the check, once the program's state is freed
    del s, snap, setup.s, setup.snap, setup.clean, window_trace, r
    takes = takes[:1]
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    correct, rows = check.verdict(
        judge(cell, capture, takes[0], failed, dev, setup.truth), limits)
    log(f"check {time.perf_counter() - t:.3f} s")
    found = forbidden_modules()
    if found:
        raise RuntimeError(f"modules loaded that the benchmark forbids: {found}")
    devinfo = {"platform": "gpu" if dev.type == "cuda" else "cpu",
               "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
               "count": 1, "memory_peak_bytes": memory_peak}
    result = {"correct": correct, "attempted": len(lat), "failed": failed,
              "metrics": metrics, "device": devinfo}
    if tr is not None:
        devinfo.update(busy_s=tr.busy_s(), window_s=tr.window_s)
        result["breakdown"] = tr.breakdown()
    result["card"] = card
    result["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in rows}
    return result
