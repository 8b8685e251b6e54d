"""Benchmark driver: full-resolution VO tracking throughput on one chip.

Prints ONE JSON line per completed phase (cumulative best-so-far), so the
LAST JSON line on stdout is always the official result even if the driver's
budget expires mid-run:
    {"metric": ..., "value": N, "unit": "frames/sec/chip", "vs_baseline": N,
     "best": N, "median": N, "passes": N}

Protocol (north star in BASELINE.md): TUM fr1/xyz-class workload -
640x480 RGB-D @ fr1 intrinsics, 500 ORB features over 8 pyramid levels,
full tracking pipeline (extract -> coarse/fine match+RANSAC+LM -> keyframe /
map management) with local BA dispatched per keyframe, exactly what
``run_vo`` times per frame at ``app/run_vo.cpp:104-109``.

Sampling protocol: every phase runs a FIXED number of independent passes
(fresh VO instance each), each pass measuring 3 windows.  The published
``value`` is the MEDIAN of the per-pass best-window FPS; ``best`` (best of
all windows) is reported alongside, and every window of every pass is
appended to ``benchmarks/bench_windows.jsonl``.

- **Budget-proof**: phases run headline-first (72-stream full VO, then
  single-stream, then tracking); a cumulative JSON line is printed after
  each completed phase, and SIGTERM/SIGALRM handlers emit the best-so-far
  JSON before dying, so a driver with a time limit always captures a
  machine-readable number.  ``BENCH_BUDGET_S`` (default 1500 s) arms the
  internal alarm; phases that cannot fit the remaining budget are skipped.
  The 64-stream fallback runs only if the 72-stream phase ran out of
  device memory.
- **Data-anchored windows**: every timed window closes by ``device_get``-ing
  real step outputs - the in-order device queue makes one materialized
  result prove all prior steps executed.  A start-of-run self-calibration
  (:func:`calibrate_timer`) times a known-FLOP bf16 matmul under the same
  pattern and aborts if it beats the device's published peak, i.e. if the
  timer did not wait for the device.  The peak comes from a table keyed by
  ``device_kind``; an unknown device is an error, never a default.

The TUM dataset cannot be downloaded in this environment (no egress), so
frames come from the synthetic renderer at identical resolution/intrinsics
and comparable feature density, moving at fr1/xyz-like speed.  The
``vs_baseline`` divisor is MEASURED: ``baseline/opencv_vo.py`` re-implements
the reference pipeline on the same OpenCV kernels it calls (ORB, FLANN-LSH,
solvePnPRansac P3P) plus twins of its g2o solvers, and was run on the
identical synthetic sequence on this host (results in
``baseline/measured.json``; full-VO and frontend-only numbers are kept
separate so each bench phase divides by the matching workload).
"""

import json
import os
import signal
import statistics
import sys
import time

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_MEASURED = json.load(open(os.path.join(_HERE, "baseline", "measured.json")))
BASELINE_FPS_FULL_VO = _MEASURED["full_vo"]["fps_mean"]
BASELINE_FPS_FRONTEND = _MEASURED["frontend_only"]["fps_mean"]
WARMUP_FRAMES = 12
MEASURE_FRAMES = 60
# multistream batches are staged in device memory up front; at 64+ streams
# the full batch sequence alone is several GB, so the batched phases use
# shorter measurement windows.  3 x 15 steps: with the deployment-matched
# BA cadence (one dispatch per 15 tracked frames, multistream_cfg) every
# window contains EXACTLY one BA dispatch - shorter windows let the
# per-pass best window be one with zero dispatches, under-counting BA work
MS_MEASURE_FRAMES = 45
# tracking-only phase: one batch size with the secondary pass count keeps
# the protocol cheap
TRACKING_STREAMS = 32
# full-VO sizes: BA dispatch cost is ~batch-size-independent, so big
# batches win.  64 is the out-of-memory FALLBACK only - it never runs when
# 72 succeeds.
FULL_VO_STREAMS = 72
FULL_VO_FALLBACK = 64
# fixed pass counts (result-independent - see module docstring)
PASSES_HEADLINE = 5
PASSES_SECONDARY = 2

WINDOW_LOG = os.path.join(_HERE, "benchmarks", "bench_windows.jsonl")

_T_START = time.monotonic()
BUDGET_S = float(os.environ.get("BENCH_BUDGET_S", "1500"))


def _remaining() -> float:
    return BUDGET_S - (time.monotonic() - _T_START)


def _log_windows(phase: str, windows, extra: dict | None = None):
    """Append every measured window of every pass to the public log."""
    try:
        os.makedirs(os.path.dirname(WINDOW_LOG), exist_ok=True)
        rec = {
            "time": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
            "phase": phase,
            "windows_fps": [[round(w, 2) for w in p] for p in windows],
        }
        if extra:
            rec.update(extra)
        with open(WINDOW_LOG, "a", encoding="utf-8") as f:
            f.write(json.dumps(rec) + "\n")
    except OSError:
        pass  # logging must never fail the bench


def _summarize(phase: str, windows) -> dict:
    """windows = [[fps per window] per pass] -> headline stats."""
    _log_windows(phase, windows)
    per_pass = [max(p) for p in windows]
    return {
        "median": float(statistics.median(per_pass)),
        "best": float(max(per_pass)),
        "passes": len(per_pass),
        "windows": windows,
    }


# Published dense bf16 tensor-core peaks, keyed by ``jax.Device.device_kind``
# (NVIDIA H100 data sheet: SXM5 989 TFLOP/s, PCIe 756 TFLOP/s, both at the
# card's full power limit).  A device missing here is an error: the
# calibration never assumes a peak.
PEAK_BF16_TFLOPS = {
    "NVIDIA H100 80GB HBM3": 989.0,  # SXM5
    "NVIDIA H100 PCIe": 756.0,
}


def peak_bf16_tflops(device_kind: str) -> float:
    """Published dense bf16 peak of ``device_kind``; raises on unknown."""
    try:
        return PEAK_BF16_TFLOPS[device_kind]
    except KeyError:
        raise ValueError(
            f"no published bf16 peak for device kind {device_kind!r}; add it "
            "to bench.PEAK_BF16_TFLOPS with its data-sheet source"
        ) from None


def calibrate_timer() -> dict:
    """Prove the measurement pattern waits for device completion.

    Times a known-FLOP matmul (4096^2 bf16 self-product: 2*4096^3 =
    137.4 GFLOP) closed by a ``device_get`` of one output element - the
    same data anchor every bench window uses.  If the measured time beats
    the device's published peak, the timer did NOT wait and the whole
    protocol is invalid: abort loudly.
    """
    import jax
    import jax.numpy as jnp

    n = 4096
    peak_tflops = peak_bf16_tflops(jax.devices()[0].device_kind)
    flops = 2.0 * n**3
    floor_s = flops / (peak_tflops * 1e12)
    x = jax.device_put(jnp.ones((n, n), jnp.bfloat16))
    f = jax.jit(lambda a: (a @ a).astype(jnp.float32))
    np.asarray(f(x)[0, :1])  # compile + warm
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        y = f(x)
        np.asarray(y[0, :1])  # data anchor: fetch forces execution
        times.append(time.perf_counter() - t0)
    measured = min(times)
    rec = {
        "calibration": "matmul",
        "n": n,
        "floor_ms": round(floor_s * 1e3, 3),
        "measured_ms": round(measured * 1e3, 3),
    }
    if measured < 0.8 * floor_s:
        raise RuntimeError(
            f"TIMER CALIBRATION FAILED: {n}x{n} bf16 matmul 'completed' in "
            f"{measured * 1e3:.3f} ms < roofline floor {floor_s * 1e3:.3f} ms "
            "- the measurement pattern returns before device execution; "
            "all window timings would be fiction. Aborting."
        )
    _log_windows("calibration", [], extra=rec)
    return rec


def _make_frames(cfg, n, seed=0):
    from rgbd_visualodometry_tpu.io import synthetic

    scene = synthetic.SyntheticScene(
        width=cfg.image_width, height=cfg.image_height,
        fx=cfg.camera_fx, fy=cfg.camera_fy, cx=cfg.camera_cx, cy=cfg.camera_cy,
        seed=seed,
    )
    return synthetic.generate_sequence(
        n, scene=scene, step_t=(0.012, 0.002, 0.0), step_r=(0.0, 0.0, 0.003)
    )


def single_stream_cfg(cfg):
    """The EXACT config the single-stream bench phase runs (exported so
    tests/test_contract_parity.py asserts the ATE parity contract under the
    same settings that produce the single-stream number).

    Rationale: the default capacities are sized for arbitrarily long runs
    (64k mappoints); every [C]- or [ba_max_points]-shaped op pays for that
    padding on every frame.  The production single-stream preset sizes the
    pools to the fr1-class deployment (the measured baseline creates ~10k
    mappoints over 240 frames; ring eviction covers longer runs) - the same
    capacities the multistream phase already runs accuracy-asserted."""
    return cfg.replace(
        max_mappoints=16384, max_keyframes=128, max_obs_per_mappoint=8,
        ba_max_points=1024, ba_max_poses=8,
        pnp_max_points=512,
        triangulation_batch=128,
        ransac_hypotheses=64,
    )


def bench_single(cfg, repeats: int = PASSES_HEADLINE) -> dict:
    from rgbd_visualodometry_tpu.pipeline.system import VisualOdometry

    scfg = single_stream_cfg(cfg)
    seq = _make_frames(scfg, WARMUP_FRAMES + 3 * MEASURE_FRAMES)
    windows = []
    staged = None
    for _ in range(max(1, repeats)):
        vo = VisualOdometry(scfg)
        # stage all frames in device memory before timing: the reference's
        # per-frame timer likewise excludes image loading (imread sits
        # outside the boost::timer window, app/run_vo.cpp:91-109) - tracking
        # throughput is the metric, not host-to-device upload
        if staged is None:
            staged = [
                (vo.put_frame(f.rgb, f.depth, f.timestamp), f.timestamp)
                for f in seq
            ]
            # anchor staging on data: materialize one element of the last
            # staged frame (in-order queue => all uploads landed)
            np.asarray(staged[-1][0].rgb[0, 0])
        for f, ts in staged[:WARMUP_FRAMES]:
            vo.process_async(f, timestamp=ts)
        vo.drain(0)  # drain() device_gets every output - a real data anchor

        pass_windows = []
        for window in range(3):
            lo = WARMUP_FRAMES + window * MEASURE_FRAMES
            t0 = time.perf_counter()
            for f, ts in staged[lo : lo + MEASURE_FRAMES]:
                vo.process_async(f, timestamp=ts)
                vo.drain(6)
            vo.drain(0)  # materializes the window's last StepOutput
            pass_windows.append(MEASURE_FRAMES / (time.perf_counter() - t0))
        tracked = sum(r.tracked for r in vo.results)
        assert tracked == len(seq), f"tracking failed: {tracked}/{len(seq)}"
        windows.append(pass_windows)
    return _summarize("single-stream full VO", windows)


def multistream_cfg(cfg, full_vo: bool = False):
    """The EXACT config the multistream bench phases run (exported so
    tests/test_contract_parity.py asserts the ATE parity contract under the
    same settings that produce the headline throughput number)."""
    return cfg.replace(
        max_mappoints=16384, max_keyframes=128, max_obs_per_mappoint=8,
        ba_max_points=1024, ba_max_poses=8,
        # typical per-frame inlier sets are 200-400 at this map scale; the
        # default 1024-slot compaction cap mostly pays for empty lanes
        # (every [C, k] inverse-lookup matrix and PnP/LM row count scales
        # with it)
        pnp_max_points=512,
        # match from the packed uint32 pool: drops the [C, 256] int8 bipolar
        # pool from per-stream state (8x less map memory per stream); which
        # layout is faster on the GPU is an open question (PERF.md)
        packed_matching=True,
        # triangulation refinement capacity per keyframe: 128 is still two
        # orders of magnitude above the reference, which `break`s after ONE
        # successful triangulation per keyframe (frontend.cpp:501); the
        # default 1024 mostly refines already-converged landmarks while its
        # [C, B] inverse-lookup scales with the batch
        triangulation_batch=128,
        # 64 hypothesis lanes (48 depth-seeded Kabsch + 16 depth-free + the
        # previous-pose seed lane): the reference's sequential RANSAC runs
        # at most 100 P3P iterations but terminates at 0.99 confidence -
        # ~7 iterations at its typical >50% inlier rates (frontend.cpp:243),
        # so 64 parallel lanes remain a strictly stronger search.  ATE under
        # this exact config is asserted by test_throughput_config_parity.
        ransac_hypotheses=64,
        enable_local_optimization=full_vo,
        # the reference backend coalesces keyframes under load (condvar
        # without a queue - latest wins, backend.cpp:8-17).  gap=14 makes
        # the dispatch rate EXACTLY deployment-matched: one batched solve
        # per 15 tracked frames per stream, identical to the measured
        # baseline (16 solves over 240 frames, baseline/measured.json);
        # every dispatch still solves ALL streams' windows.  (Round 4 ran
        # gap=9 = 1.5x the baseline's per-frame BA rate; the ATE parity
        # contract holds at both - test_throughput_config_parity pins it
        # at this exact config.)
        ba_min_frame_gap=max(cfg.ba_min_frame_gap, 14) if full_vo else cfg.ba_min_frame_gap,
    )


def bench_multistream(
    cfg,
    n_streams: int,
    full_vo: bool = False,
    repeats: int = PASSES_SECONDARY,
) -> dict:
    """S independent streams vmapped on one device (map capacities scaled
    down to fit S maps in device memory).  ``full_vo=True`` runs per-stream local BA
    (pred-masked vmapped ba_step) - the same workload as the measured
    baseline's enable_local_optimization=1 deployment.

    ``repeats`` independent passes (fresh VO instance each) over the same
    staged batches; the pass count is FIXED up front (never conditioned on
    the measured result) and every window lands in the log.

    Every window closes on a DATA anchor: the last step's [S, 32] packed
    output is device_get - the in-order device queue means its arrival
    proves every prior step of the window executed.
    """
    from rgbd_visualodometry_tpu.parallel import MultiStreamVO, make_mesh

    mcfg = multistream_cfg(cfg, full_vo=full_vo)
    mesh = make_mesh(1)
    seqs = [_make_frames(mcfg, WARMUP_FRAMES + MS_MEASURE_FRAMES, seed=s) for s in range(n_streams)]

    def batch(i):
        rgb = np.stack([s[i].rgb for s in seqs])
        depth = np.stack([s[i].depth for s in seqs])
        ts = np.asarray([s[i].timestamp for s in seqs])
        return rgb, depth, ts

    vo = MultiStreamVO(mcfg, n_streams=n_streams, mesh=mesh)
    # stage every batch on device before timing (see bench_single for why);
    # anchor on one element of the last batch (in-order queue)
    batches = [vo.put_batch(*batch(i)) for i in range(len(seqs[0]))]
    np.asarray(batches[-1].rgb[0, 0, 0])

    windows = []
    n_meas = (len(batches) - WARMUP_FRAMES) // 3
    for rep in range(max(1, repeats)):
        if rep > 0:
            vo = MultiStreamVO(mcfg, n_streams=n_streams, mesh=mesh)
        for fb in batches[:WARMUP_FRAMES]:
            out = vo.step(fb)
        vo.finish()
        np.asarray(out.packed)  # data anchor: warmup fully executed
        pass_windows = []
        for window in range(3):
            lo = WARMUP_FRAMES + window * n_meas
            t0 = time.perf_counter()
            for fb in batches[lo : lo + n_meas]:
                out = vo.step(fb)
            vo.finish()
            np.asarray(out.packed)  # data anchor closes the window
            pass_windows.append(
                n_streams * n_meas / (time.perf_counter() - t0)
            )
        assert bool(out.tracked.all()), "a stream lost tracking"
        windows.append(pass_windows)
    mode = "full VO" if full_vo else "tracking"
    return _summarize(f"{n_streams}-stream batched {mode}", windows)


class _Reporter:
    """Holds completed phases; prints the cumulative best-so-far JSON line.

    The LAST JSON line on stdout is the official result; printing after
    every phase (and from the signal handlers) guarantees the driver parses
    a number even if its budget expires mid-run."""

    def __init__(self):
        self.phases = []  # (ratio, summary, mode_label)

    def add(self, summary, divisor, label):
        self.phases.append((summary["median"] / divisor, summary, label))
        self.emit()

    def emit(self):
        if not self.phases:
            return False
        ratio, phase, mode = max(self.phases, key=lambda c: c[0])
        print(
            json.dumps(
                {
                    "metric": f"synthetic fr1-class 640x480 tracking FPS/chip ({mode})",
                    "value": round(phase["median"], 2),
                    "unit": "frames/sec/chip",
                    "vs_baseline": round(ratio, 2),
                    # strongest-twin bound (BASELINE.md sensitivity table):
                    # the reference's backend rides a second CPU core, so
                    # the most favorable twin runs its frontend at full
                    # speed with BA free - frontend-only FPS is the ceiling
                    # of any fair full-VO twin on multicore hardware
                    "vs_strongest_twin": round(
                        phase["median"] / BASELINE_FPS_FRONTEND, 2
                    ),
                    "best": round(phase["best"], 2),
                    "median": round(phase["median"], 2),
                    "passes": phase["passes"],
                }
            ),
            flush=True,
        )
        return True


def main():
    from rgbd_visualodometry_tpu.config import VOConfig
    from rgbd_visualodometry_tpu.utils import enable_compilation_cache

    enable_compilation_cache()
    cfg = VOConfig()  # full fr1 defaults: 640x480, 500 features, 8 levels
    reporter = _Reporter()

    def bail(signum, frame):
        print(f"[bench] signal {signum}: emitting best-so-far JSON", file=sys.stderr)
        had = reporter.emit()
        os._exit(0 if had else 1)

    signal.signal(signal.SIGTERM, bail)
    signal.signal(signal.SIGALRM, bail)
    # leave ~20 s of headroom to flush before the driver's own kill lands
    signal.alarm(max(int(BUDGET_S) - 20, 30))

    def report(tag, r):
        print(
            f"[bench] {tag}: median {r['median']:.2f} / best {r['best']:.2f} "
            f"FPS over {r['passes']} passes ({_remaining():.0f}s budget left)",
            file=sys.stderr, flush=True,
        )

    cal = calibrate_timer()
    print(f"[bench] timer calibration: {cal}", file=sys.stderr, flush=True)

    # ---- phase 1 (headline): 72-stream full VO -----------------------------
    full_vo_ok = False
    try:
        got = bench_multistream(cfg, FULL_VO_STREAMS, full_vo=True, repeats=PASSES_HEADLINE)
        report(f"{FULL_VO_STREAMS}-stream full VO", got)
        reporter.add(got, BASELINE_FPS_FULL_VO, f"{FULL_VO_STREAMS}-stream batched full VO")
        full_vo_ok = True
    except Exception as e:
        print(f"[bench] {FULL_VO_STREAMS}-stream full VO failed: {e!r}", file=sys.stderr)
        # only a clean OOM leaves the device usable for a smaller batch
        if "RESOURCE_EXHAUSTED" in str(e) or "out of memory" in str(e).lower():
            try:
                got = bench_multistream(cfg, FULL_VO_FALLBACK, full_vo=True, repeats=PASSES_SECONDARY)
                report(f"{FULL_VO_FALLBACK}-stream full VO", got)
                reporter.add(got, BASELINE_FPS_FULL_VO, f"{FULL_VO_FALLBACK}-stream batched full VO")
                full_vo_ok = True
            except Exception as e2:
                print(f"[bench] fallback failed too: {e2!r}", file=sys.stderr)

    # ---- phase 2: single-stream full VO (production latency loop) ----------
    if _remaining() > 240:
        try:
            single = bench_single(cfg)
            report("single-stream full VO", single)
            reporter.add(single, BASELINE_FPS_FULL_VO, "single-stream full VO")
        except Exception as e:
            print(f"[bench] single-stream failed: {e!r}", file=sys.stderr)
            if not full_vo_ok:
                raise
    else:
        print("[bench] skipping single-stream phase (budget)", file=sys.stderr)

    # ---- phase 3: batched tracking (frontend-only comparison point) --------
    if _remaining() > 180:
        try:
            got = bench_multistream(cfg, TRACKING_STREAMS, full_vo=False, repeats=1)
            report(f"{TRACKING_STREAMS}-stream tracking", got)
            reporter.add(got, BASELINE_FPS_FRONTEND, f"{TRACKING_STREAMS}-stream batched tracking")
        except Exception as e:
            print(f"[bench] tracking phase failed: {e!r}", file=sys.stderr)
    else:
        print("[bench] skipping tracking phase (budget)", file=sys.stderr)

    signal.alarm(0)
    if not reporter.emit():
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
