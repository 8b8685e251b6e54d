"""Host-side system orchestrator.

Equivalent of the object wiring and main loop in ``app/run_vo.cpp:72-128``
(Camera + FrontEnd + optional Backend + optional Viewer), minus the threads.

Latency design - the steady-state loop performs **zero synchronous host
round-trips per frame**, so the host never waits on the device between
frames:

- tracking and local BA are two cached programs on the same in-order
  device queue; BA is dispatched (without blocking) when a keyframe's
  lagged output is materialized, optimizing whatever the latest map state
  is by then - the direct analogue of the reference's backend thread +
  condvar ("latest keyframe wins", ``backend.h:33-37``).  A device-side
  ``lax.cond`` fusion was tried and rejected: XLA's conditional copies the
  whole ~200 MB state through the identity branch every frame,
- frame inputs are enqueued with async ``device_put``/dispatch,
- outputs are materialized with a configurable lag (default 3 frames), so
  LOST detection trails by at most that many frames - the trailing frames
  are no-ops in the LOST state (``frontend.cpp:146-148``) and produce no
  trajectory entries, exactly like the reference's immediate stop.
"""

from __future__ import annotations

import collections
import functools
import time
from dataclasses import dataclass, field
from typing import Any, Optional

import jax
import jax.numpy as jnp
import numpy as np

from rgbd_visualodometry_tpu import mapstate
from rgbd_visualodometry_tpu.camera import Camera
from rgbd_visualodometry_tpu.config import VOConfig
from rgbd_visualodometry_tpu.mapstate import LOST
from rgbd_visualodometry_tpu.pipeline import backend as backend_mod
from rgbd_visualodometry_tpu.pipeline import frontend as frontend_mod




@dataclass
class FrameResult:
    """Host-friendly per-frame record (stats mirror the reference's logs)."""

    timestamp: float
    tracked: bool
    fsm: int
    is_keyframe: bool
    pose_w_c: np.ndarray  # [7] (qw qx qy qz tx ty tz)
    pose_c_w: np.ndarray
    stats: dict[str, int] = field(default_factory=dict)
    step_seconds: float = 0.0


class VisualOdometry:
    """The user-facing system object (the FrontEnd+Backend pair of the
    reference, with the map state owned functionally instead of globally).

    Usage::

        vo = VisualOdometry(cfg)
        for rgb, depth, t in frames:
            res = vo.process(rgb, depth, t)
            if res.fsm == LOST: break
    """

    def __init__(self, cfg: VOConfig, seed: int = 0, device: Optional[Any] = None):
        from rgbd_visualodometry_tpu.utils import enable_compilation_cache

        enable_compilation_cache()
        self.cfg = cfg
        self.camera = Camera.from_config(cfg)
        self.device = device or jax.devices()[0]
        self.state = jax.device_put(mapstate.init_state(cfg, seed), self.device)
        self._step = jax.jit(
            functools.partial(frontend_mod.track_step, cfg, self.camera),
            donate_argnums=0,
        )
        self._ba = jax.jit(
            functools.partial(backend_mod.ba_step, cfg, self.camera),
            donate_argnums=0,
        )
        self.enable_backend = bool(cfg.enable_local_optimization)
        # Absolute-time origin: device-side timestamps (FrameInput.timestamp,
        # VOState.kf_timestamp) are float32, which cannot hold TUM epoch
        # stamps (~1.39e9 s) to better than ~2 minutes.  The first staged
        # frame's timestamp becomes the origin; the device only ever sees
        # offsets (f32-exact for hours-long sequences), and host-side results
        # / trajectories keep the absolute float64 value.
        self.time_base: Optional[float] = None
        self.results: list[FrameResult] = []
        self.num_auto_relaxes = 0  # online loop closures (relax_every_kf)
        # async loop-closure worker (cfg.relax_async): at most one in flight
        self._relax_thread = None
        self._relax_result = None
        self._relax_exc: Optional[BaseException] = None
        self._pending: collections.deque = collections.deque()
        self._frames_since_ba = 1 << 30
        # observability: local BA solves dispatched (the reference backend
        # thread's wake count; MultiStreamVO keeps the same counter)
        self.ba_dispatches = 0
        # live viewer (the reference's render thread, viewer.cpp:34-54):
        # per-frame keypoint overlays + periodic map renders, host-side and
        # fed from the lagged output stream so the hot loop never blocks
        self._viewer = None
        self._viewer_frame = 0
        if cfg.enable_viewer:
            from rgbd_visualodometry_tpu.viz import MapViewer

            self._viewer = MapViewer(cfg.viewer_dir)

    # ---- async pipeline --------------------------------------------------

    def put_frame(
        self, rgb: np.ndarray, depth: np.ndarray, timestamp: float
    ) -> frontend_mod.FrameInput:
        """Stage one frame on device (async H2D; does not block).

        Staging is separated from tracking so callers can overlap uploads
        with compute - the reference's timing hook likewise excludes image
        loading (``imread`` sits outside the per-frame timer,
        ``app/run_vo.cpp:91-109``).

        The staged timestamp is the offset from the first staged frame (see
        ``time_base`` in ``__init__``) so float32 device storage stays
        precise for real TUM epoch stamps."""
        if self.time_base is None:
            self.time_base = float(timestamp)
        return frontend_mod.FrameInput(
            rgb=jnp.asarray(rgb, jnp.uint8),
            depth=jnp.asarray(depth, jnp.uint16),
            timestamp=jnp.float32(float(timestamp) - self.time_base),
        )

    def process_async(self, rgb, depth=None, timestamp=None, rgb_ref=None):
        """Enqueue one frame; no host synchronization (the hot path).

        Accepts either ``(rgb, depth, timestamp)`` numpy arrays or a
        pre-staged :class:`FrameInput` (from :meth:`put_frame`).  With the
        viewer enabled, staged callers may pass ``rgb_ref`` (the host-side
        image) for the overlay; otherwise the overlay reads the staged
        device copy back when the lagged drain materializes the frame -
        correct, but a D2H image transfer off the hot path."""
        t0 = time.perf_counter()
        if isinstance(rgb, frontend_mod.FrameInput):
            frame = rgb
            if timestamp is None:
                # blocking scalar fetch (one device round-trip) - callers
                # on the hot path should pass the host value.
                # Staged inputs hold time offsets; add the origin back.
                timestamp = float(frame.timestamp) + (self.time_base or 0.0)
            if rgb_ref is None and self._viewer is not None:
                rgb_ref = frame.rgb  # device copy; fetched at materialize
        else:
            if rgb_ref is None and self._viewer is not None:
                rgb_ref = rgb  # host copy for overlay
            frame = self.put_frame(rgb, depth, timestamp)
        self.state, out = self._step(self.state, frame)
        # start the (128-byte) result record moving to the host NOW: by the
        # time the lagged drain reads it the bytes are already local, so
        # materializing never pays the device link's round-trip latency
        out.packed.copy_to_host_async()
        if out.viewer is not None:
            out.viewer.copy_to_host_async()
        self._pending.append((float(timestamp), out, time.perf_counter() - t0, rgb_ref))

    def _materialize(self, ts: float, out, dispatch_s: float, rgb_ref=None) -> FrameResult:
        o = jax.device_get(out)  # ONE host transfer for the whole record
        self._frames_since_ba += 1
        if (
            self.enable_backend
            and bool(o.needs_ba)
            and self._frames_since_ba > self.cfg.ba_min_frame_gap
        ):
            # async backend dispatch on the lagged keyframe ("latest state
            # wins"); the device queue serializes it after in-flight steps.
            # ba_min_frame_gap reproduces the reference backend's keyframe
            # coalescing under load (backend.cpp:8-17)
            self.state, _ = self._ba(self.state, jnp.int32(int(o.kf_slot)))
            self._frames_since_ba = 0
            self.ba_dispatches += 1
        res = FrameResult(
            timestamp=ts,
            tracked=bool(o.tracked),
            fsm=int(o.fsm),
            is_keyframe=bool(o.is_keyframe),
            pose_w_c=np.asarray(o.pose_w_c),
            pose_c_w=np.asarray(o.pose_c_w),
            stats=dict(
                num_candidates=int(o.num_candidates),
                num_matches=int(o.num_matches),
                num_inliers=int(o.num_inliers),
                num_final_inliers=int(o.num_final_inliers),
                num_new_mappoints=int(o.num_new_mappoints),
                num_triangulated=int(o.num_triangulated),
                num_keyframes=int(o.num_keyframes),
                num_mappoints=int(o.num_mappoints),
                kf_overflow=int(o.kf_overflow),
                num_dropped_mappoints=int(o.num_dropped_mappoints),
            ),
            step_seconds=dispatch_s,
        )
        self.results.append(res)
        if self._viewer is not None and o.viewer is not None and rgb_ref is not None:
            v = np.asarray(o.viewer)
            self._viewer.render_overlay(
                np.asarray(rgb_ref), v[:, :2], v[:, 2] > 0.5,
                name=f"frame_{self._viewer_frame:05d}.png",
            )
            if self._viewer_frame % max(self.cfg.viewer_map_every, 1) == 0:
                traj = np.asarray(
                    [r.pose_w_c[4:7] for r in self.results if r.tracked]
                )
                self._viewer.render_map(
                    self.map_snapshot(), trajectory=traj,
                    name=f"map_{self._viewer_frame:05d}.png",
                )
                # live-refresh the interactive 3D map on the same cadence:
                # `map.html` is rewritten in place, so a browser tab on it is
                # the headless equivalent of the reference's always-current
                # Pangolin window (src/viewer.cpp:34-54) during a long run
                self.export_map_html()
            self._viewer_frame += 1
        return res

    def drain(self, keep_lag: int = 0) -> Optional[FrameResult]:
        """Materialize pending outputs, leaving up to ``keep_lag`` in flight."""
        last = None
        while len(self._pending) > keep_lag:
            last = self._materialize(*self._pending.popleft())
        return last

    # ---- synchronous convenience (run_vo.cpp:104-109 semantics) ----------

    def process(self, rgb: np.ndarray, depth: np.ndarray, timestamp: float) -> FrameResult:
        """Track one frame and synchronously return its result."""
        self.process_async(rgb, depth, timestamp)
        return self.drain(0)

    @property
    def lost(self) -> bool:
        return bool(self.results) and self.results[-1].fsm == LOST

    def run(
        self,
        frames,
        trajectory_path: Optional[str] = None,
        verbose: bool = False,
        lag: int = 3,
        stats_path: Optional[str] = None,
    ):
        """Dataset loop mirroring ``run_vo.cpp:89-117``: track every frame,
        stream TUM-format poses of tracked frames, stop on LOST.

        ``stats_path`` streams one JSON record per frame - the structured
        counterpart of the reference's per-stage stdout logs (SURVEY.md
        section 5 observability row).
        """
        import json

        from rgbd_visualodometry_tpu.io.trajectory import TrajectoryWriter

        writer = TrajectoryWriter(trajectory_path) if trajectory_path else None
        stats_f = open(stats_path, "w", encoding="utf-8") if stats_path else None
        written = 0

        def flush(keep_lag):
            nonlocal written
            self.drain(keep_lag)
            for res in self.results[written:]:
                if verbose:
                    s = res.stats
                    print(
                        f"t={res.timestamp:.3f} fsm={res.fsm} kf={int(res.is_keyframe)} "
                        f"match={s['num_matches']} inlier={s['num_inliers']} "
                        f"map={s['num_mappoints']}"
                    )
                if stats_f:
                    stats_f.write(
                        json.dumps(
                            dict(
                                timestamp=res.timestamp,
                                tracked=res.tracked,
                                fsm=res.fsm,
                                is_keyframe=res.is_keyframe,
                                **res.stats,
                            )
                        )
                        + "\n"
                    )
                # the reference writes every non-LOST frame's estimated pose,
                # quality gate or not (run_vo.cpp:116 is unconditional);
                # default skips untracked frames, compat flag restores parity
                write_ok = res.tracked or self.cfg.compat_write_untracked_poses
                if writer and write_ok and res.fsm != LOST:
                    writer.write(res.timestamp, res.pose_w_c)
            written = len(self.results)

        # the reference aborts on LOST (run_vo.cpp:111-114); with
        # relocalization enabled we keep feeding frames so the tracker can
        # re-enter TRACKING from the map
        stop_on_lost = not self.cfg.enable_relocalization
        # online loop closure: relax the whole keyframe graph every N
        # keyframes (relax_every_kf > 0).  After each relaxation every
        # already-materialized pose is corrected in memory (each frame moves
        # rigidly with its reference keyframe) and the trajectory file is
        # re-emitted, so the streamed output always reflects the current
        # world - what a user of the reference's live viewer sees
        # (src/viewer.cpp:34-54)
        auto_n = int(self.cfg.relax_every_kf or 0)
        use_async = bool(auto_n and self.cfg.relax_async)
        kf_at_last_relax = 0

        def relax_done(rep):
            if rep.kf_ts.size and writer:
                writer.rewrite(self._trajectory_entries())
            if verbose:
                print(
                    f"auto relax #{self.num_auto_relaxes}: "
                    f"{rep.num_loop_edges} loop + "
                    f"{rep.num_appearance_edges} appearance edges, "
                    f"max correction {rep.max_correction_m * 100:.2f} cm"
                )

        def auto_relax():
            # synchronous path (cfg.relax_async=False or end-of-run):
            # materialize in-flight frames first - they tracked against the
            # pre-relax map and must be corrected too
            flush(0)
            # require_loop: a relaxation without loop evidence is a no-op
            # (its short-gap Kabsch edges are noisier than the BA-refined
            # poses - see globalopt.relax_map)
            rep = self.global_relax(
                loop_gap_s=self.cfg.relax_loop_gap_s, require_loop=True
            )
            self.num_auto_relaxes += 1
            if rep.kf_ts.size:
                self._apply_relax_correction(rep)
            relax_done(rep)

        try:
            for rgb, depth, ts in frames:
                self.process_async(rgb, depth, ts)
                flush(lag)
                if auto_n:
                    kf_seen = sum(int(r.is_keyframe) for r in self.results)
                    if kf_seen - kf_at_last_relax >= auto_n:
                        if use_async:
                            # skip if one is already in flight (latest wins)
                            if self._relax_thread is None:
                                kf_at_last_relax = kf_seen
                                self._start_async_relax()
                        else:
                            kf_at_last_relax = kf_seen
                            auto_relax()
                    if use_async:
                        rlx = self._finish_async_relax()
                        if rlx is not None:
                            relax_done(rlx.report)
                if stop_on_lost and self.lost:
                    break
            flush(0)
            if auto_n:
                if use_async:
                    rlx = self._finish_async_relax(wait=True)
                    if rlx is not None:
                        relax_done(rlx.report)
                # close the run with one final relaxation so a loop that
                # completes after the last cadence point still corrects the
                # streamed trajectory
                auto_relax()
        finally:
            if use_async and self._relax_thread is not None:
                # never leak the worker past the run (apply or discard)
                try:
                    rlx = self._finish_async_relax(wait=True)
                    if rlx is not None:
                        relax_done(rlx.report)
                except Exception:
                    pass
            if writer:
                writer.close()
            if stats_f:
                stats_f.close()
            if self._viewer is not None:
                # final INTERACTIVE 3D map (orbit/zoom in a browser) - the
                # headless stand-in for the reference's live Pangolin window
                self.export_map_html()
        return self.results

    def _trajectory_entries(self):
        """(timestamp, pose_w_c) rows under the run loop's write filter."""
        return [
            (r.timestamp, r.pose_w_c)
            for r in self.results
            if (r.tracked or self.cfg.compat_write_untracked_poses)
            and r.fsm != LOST
        ]

    def _apply_relax_correction(self, report) -> None:
        """Move every materialized frame result rigidly with its reference
        keyframe's relaxation delta (``globalopt.correct_trajectory``), so
        in-memory poses - and anything re-emitted from them - reflect the
        post-relax world."""
        from rgbd_visualodometry_tpu.ops import se3
        from rgbd_visualodometry_tpu.pipeline import globalopt

        if report.kf_ts.size == 0 or not self.results:
            return
        base = self.time_base or 0.0
        ts = np.asarray([r.timestamp for r in self.results]) - base
        poses = np.asarray([r.pose_w_c for r in self.results], np.float32)
        new_w_c = globalopt.correct_trajectory(report, ts, poses)
        new_c_w = np.asarray(se3.inverse(jnp.asarray(new_w_c)))
        for r, pw, pc in zip(self.results, new_w_c, new_c_w):
            r.pose_w_c = pw
            r.pose_c_w = pc

    # ---- asynchronous online loop closure ---------------------------------

    def _start_async_relax(self) -> None:
        """Fire ``compute_relaxation`` on a state SNAPSHOT on a worker
        thread.  The frame loop keeps tracking; graph build, Horn edges,
        (first-firing) compiles and the pose-graph solve all happen off the
        hot path.  At most one relaxation is in flight ("latest wins" -
        the reference backend's condvar semantics, ``backend.h:33-37``)."""
        import threading

        from rgbd_visualodometry_tpu.pipeline import globalopt

        if self._relax_thread is not None:
            return
        # deep-copy: the tracking step DONATES its state buffers, so the
        # worker must own the snapshot's (one async device-side copy)
        snapshot = jax.tree.map(jnp.copy, self.state)
        cfg = self.cfg

        def worker():
            try:
                self._relax_result = globalopt.compute_relaxation(
                    snapshot, cfg,
                    loop_gap_s=cfg.relax_loop_gap_s, require_loop=True,
                )
            except BaseException as e:  # surfaced on the main thread
                self._relax_exc = e

        t = threading.Thread(target=worker, daemon=True, name="vo-relax")
        self._relax_thread = t
        t.start()

    def _finish_async_relax(self, wait: bool = False):
        """If the in-flight relaxation finished (or ``wait``), apply it to
        the LIVE state (keyframes created since the snapshot move rigidly
        with the snapshot's newest keyframe - ``globalopt.apply_relaxation``)
        and correct the already-materialized results.  Returns the
        ``globalopt.Relaxation`` when one was consumed, else None."""
        from rgbd_visualodometry_tpu.pipeline import globalopt

        t = self._relax_thread
        if t is None or (not wait and t.is_alive()):
            return None
        t.join()
        self._relax_thread = None
        if self._relax_exc is not None:
            exc, self._relax_exc = self._relax_exc, None
            raise exc
        rlx, self._relax_result = self._relax_result, None
        self.num_auto_relaxes += 1
        if rlx is not None and rlx.report.kf_ts.size:
            self.state = globalopt.apply_relaxation(self.state, rlx)
            self._apply_relax_correction(rlx.report)
        return rlx

    def export_map_html(self, edges=None, name: str = "map.html"):
        """(Re-)export the interactive 3D HTML map, optionally with loop
        constraint segments (``RelaxReport.loop_pairs_w``) drawn in green.
        No-op unless the viewer is enabled."""
        if self._viewer is None:
            return None
        traj = np.asarray(
            [r.pose_w_c[4:7] for r in self.results if r.tracked]
        )
        return self._viewer.export_html(
            self.map_snapshot(), trajectory=traj, edges=edges, name=name
        )

    def global_relax(self, **kwargs):
        """Offline loop-closure relaxation of the whole map (net-new vs
        the reference, whose optimizer never leaves the local covisible
        window - ``src/backend.cpp:19-195``).  Builds the co-observation
        pose graph, relaxes every keyframe, and deforms mappoints + the
        tracking reference rigidly with their anchor keyframes, so it is
        safe to call mid-run and keep tracking.

        Returns a ``globalopt.RelaxReport``; pass it to
        ``globalopt.correct_trajectory`` to fix up per-frame poses written
        before the relaxation (frame timestamps minus ``time_base``).
        """
        from rgbd_visualodometry_tpu.pipeline import globalopt

        self.state, report = globalopt.relax_map(self.state, self.cfg, **kwargs)
        return report

    def map_snapshot(self) -> dict[str, np.ndarray]:
        """Host copy of the live map (for the viewer / checkpointing)."""
        s = self.state
        alive = np.asarray(s.mp_alive)
        return dict(
            mappoints=np.asarray(s.mp_pos).T[alive],  # [3, C] pool -> [n, 3]
            keyframe_poses=np.asarray(s.kf_pose)[np.asarray(s.kf_valid)],
            num_keyframes=int(s.num_kf),
        )
