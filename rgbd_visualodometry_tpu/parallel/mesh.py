"""Device-mesh parallelism for the VO pipeline.

Two orthogonal strategies (SURVEY.md section 2c "throughput scaling" row):

- **Data parallelism over streams** (:class:`MultiStreamVO`): N independent
  RGB-D streams tracked simultaneously, one ``vmap``-ped tracking step jitted
  over a ``Mesh`` with states and frames sharded along the ``stream`` axis.
  Streams are embarrassingly parallel - XLA inserts no collectives in the
  hot path; only aggregate metrics cross chips (a single ``psum``-style
  reduction at the end).
- **Tensor parallelism over the map** (:func:`sharded_match_descriptors`):
  the mappoint descriptor pool is sharded across devices; each device
  computes Hamming distances against its shard and the global minimum is
  combined with one collective - the classic
  shard-the-weights/replicate-the-activations layout applied to descriptor
  matching.  Useful when one map is too big for a device or one stream must
  go faster than a single device allows.

Both compile and run on any mesh size; tests exercise them on a virtual
8-device CPU mesh (`conftest.py`), and the driver's ``dryrun_multichip``
validates the same code path.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from rgbd_visualodometry_tpu import mapstate
from rgbd_visualodometry_tpu.camera import Camera
from rgbd_visualodometry_tpu.config import VOConfig
from rgbd_visualodometry_tpu.pipeline import backend as backend_mod
from rgbd_visualodometry_tpu.pipeline import frontend as frontend_mod
from rgbd_visualodometry_tpu.pipeline.system import VisualOdometry


def make_mesh(n_devices: Optional[int] = None, axis: str = "stream", devices=None) -> Mesh:
    devs = devices if devices is not None else jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (axis,))


class MultiStreamVO:
    """Track ``n_streams`` independent sequences, sharded over a mesh.

    The per-stream state pytree gets a leading stream axis; every leaf is
    sharded on that axis, so each chip owns ``n_streams / n_devices``
    complete VO instances - map, RNG, FSM and all.
    """

    def __init__(self, cfg: VOConfig, n_streams: int, mesh: Mesh, seed: int = 0):
        if n_streams % mesh.devices.size != 0:
            raise ValueError(
                f"n_streams={n_streams} must divide evenly over {mesh.devices.size} devices"
            )
        self.cfg = cfg
        self.mesh = mesh
        self.n_streams = n_streams
        self.camera = Camera.from_config(cfg)
        axis = mesh.axis_names[0]

        def shard(spec_prefix):
            return NamedSharding(mesh, P(spec_prefix))

        states = jax.vmap(lambda s: mapstate.init_state(cfg, 0)._replace(
            rng=jax.random.fold_in(jax.random.PRNGKey(seed), s)
        ))(jnp.arange(n_streams))

        # The step runs as TWO chained device programs (tracking compute,
        # then state update; see frontend.TrackInter).  No host round-trip
        # between them - the second launch is enqueued async.
        compute = functools.partial(frontend_mod.track_compute, cfg, self.camera)
        update = functools.partial(frontend_mod.apply_updates, cfg, self.camera)
        if mesh.devices.size == 1:
            # single device: plain vmap, no sharding annotations (a
            # 1-device mesh gains nothing from them)
            self._state_sharding = None
            self.states = states
            self._compute = jax.jit(jax.vmap(compute))
            self._update = jax.jit(jax.vmap(update), donate_argnums=0)
        else:
            self._state_sharding = jax.tree_util.tree_map(
                lambda _: shard(axis), mapstate.init_state(cfg)
            )
            self.states = jax.device_put(states, self._state_sharding)
            self._compute = jax.jit(
                jax.vmap(compute),
                in_shardings=(self._state_sharding, shard(axis)),
            )
            self._update = jax.jit(
                jax.vmap(update),
                in_shardings=(self._state_sharding, shard(axis)),
                out_shardings=(self._state_sharding, shard(axis)),
                donate_argnums=0,
            )

        # optional per-stream local BA (full-VO multistream): one vmapped,
        # pred-masked ba_step - streams whose lagged output requested BA get
        # the solve, the rest keep their state (select on every leaf).  The
        # host only reads the LAGGED packed outputs ([S, 32] floats, one
        # small transfer per drained frame), preserving the reference's
        # asynchronous latest-keyframe-wins backend at batch scale.
        self.enable_backend = bool(cfg.enable_local_optimization)
        # per-stream absolute-time origin (see VisualOdometry.time_base):
        # device timestamps are f32 offsets from each stream's first frame
        self.time_base: Optional[np.ndarray] = None
        self._ba_lag = 3
        self._ba_pending: list = []
        self._frames_since_ba = 1 << 30
        # observability: how many batched BA solves were dispatched (the
        # analogue of the reference backend thread's wake count)
        self.ba_dispatches = 0
        if self.enable_backend:
            ba = functools.partial(backend_mod.ba_step, cfg, self.camera)

            def masked_ba(state, kf, pred):
                new_state, _ = ba(state, kf)
                return jax.tree_util.tree_map(
                    lambda a, b: jnp.where(pred, a, b), new_state, state
                )

            if mesh.devices.size == 1:
                self._ba = jax.jit(jax.vmap(masked_ba), donate_argnums=0)
            else:
                self._ba = jax.jit(
                    jax.vmap(masked_ba),
                    in_shardings=(self._state_sharding, shard(axis), shard(axis)),
                    out_shardings=self._state_sharding,
                    donate_argnums=0,
                )

    def put_batch(
        self, rgb: np.ndarray, depth: np.ndarray, timestamps: np.ndarray
    ) -> frontend_mod.FrameInput:
        """Stage one [S, ...] frame batch on device (async H2D).

        Mirrors ``VisualOdometry.put_frame``: staging is separate from
        tracking so uploads overlap compute (the reference times only
        ``AddFrame``, not ``imread`` - ``app/run_vo.cpp:91-109``), and the
        device only sees per-stream offsets from the first batch's stamps
        (f32-safe for TUM epoch values; ``time_base`` keeps the origins)."""
        ts = np.asarray(timestamps, np.float64)
        if self.time_base is None:
            self.time_base = ts
        return frontend_mod.FrameInput(
            rgb=jnp.asarray(rgb, jnp.uint8),
            depth=jnp.asarray(depth, jnp.uint16),
            timestamp=jnp.asarray(ts - self.time_base, jnp.float32),
        )

    def step(self, rgb, depth=None, timestamps=None):
        """One tracking step for all streams.

        rgb [S, H, W, 3] uint8, depth [S, H, W] uint16, timestamps [S] -
        or a single pre-staged FrameInput from :meth:`put_batch`.
        Returns the batched StepOutput (leaves have leading stream axis).
        """
        if isinstance(rgb, frontend_mod.FrameInput):
            frames = rgb
        else:
            frames = self.put_batch(rgb, depth, timestamps)
        inter = self._compute(self.states, frames)
        self.states, out = self._update(self.states, inter)
        # move the [S, 32] result record toward the host immediately so the
        # lagged BA drain below never blocks on link latency
        out.packed.copy_to_host_async()
        if self.enable_backend:
            self._ba_pending.append(out)
            self._drain_ba(self._ba_lag)
        return out

    def _drain_ba(self, keep_lag: int):
        """Materialize lagged outputs; dispatch the masked vmapped BA when
        any stream inserted a keyframe (ba_min_frame_gap coalescing as in
        the single-stream system / reference backend.cpp:8-17)."""
        while len(self._ba_pending) > keep_lag:
            # ONE host copy of the whole [S, 32] record (already in flight
            # via copy_to_host_async).  Reading the device-side accessors
            # (`np.asarray(o.needs_ba)`) instead would dispatch a fresh
            # slicing program + a blocking D2H fetch PER FIELD.
            o = jax.device_get(self._ba_pending.pop(0))
            needs = np.asarray(o.needs_ba)
            self._frames_since_ba += 1
            if needs.any() and self._frames_since_ba > self.cfg.ba_min_frame_gap:
                self.states = self._ba(
                    self.states,
                    jnp.asarray(np.asarray(o.kf_slot), jnp.int32),
                    jnp.asarray(needs),
                )
                self._frames_since_ba = 0
                self.ba_dispatches += 1

    def finish(self):
        """Drain any lagged BA dispatches (call once after the last step)."""
        if self.enable_backend:
            self._drain_ba(0)

    def aggregate_metrics(self, out) -> dict[str, float]:
        """Cross-stream (and therefore cross-chip) reduction of counters."""
        return dict(
            tracked_fraction=float(jnp.mean(out.tracked.astype(jnp.float32))),
            mean_inliers=float(jnp.mean(out.num_inliers.astype(jnp.float32))),
            total_mappoints=int(jnp.sum(out.num_mappoints)),
        )


def map_partition_specs(cfg: VOConfig, axis: str = "map"):
    """PartitionSpec pytree sharding VOState's mappoint (C) axis over
    ``axis``.  The pools are C-minor (mapstate.py docstring), so C is the
    LAST dim of every ``mp_*`` / ``obs_*`` leaf except ``mp_bip`` (row-major
    ``[C, 256]``) and the incidence matrix ``A_inc [K, C]`` (second dim) -
    everything else (keyframes, FSM scalars, RNG) replicated."""
    template = mapstate.init_state(cfg)
    specs = {}
    for name, leaf in template._asdict().items():
        if name in ("A_inc",):
            specs[name] = P(None, axis)
        elif name == "mp_bip":
            specs[name] = P(*((axis,) + (None,) * (leaf.ndim - 1)))
        elif name.startswith(("mp_", "obs_")):
            specs[name] = P(*((None,) * (leaf.ndim - 1) + (axis,)))
        else:
            specs[name] = P()
    return mapstate.VOState(**specs)


class ShardedMapVO(VisualOdometry):
    """Tensor-parallel single-stream VO: ONE tracking stream whose mappoint
    pool is sharded across the mesh (the sharded map as a real pipeline
    mode, not a standalone demo).

    This is the scaling-book recipe applied to the map: annotate the C axis
    of every pool leaf with a sharding and jit the unmodified ``track_step``
    / ``ba_step`` - XLA's SPMD partitioner splits the Hamming-distance
    matmul (``[C, 256] x [N, 256]``, the dominant FLOP block,
    ``src/frontend.cpp:186-187``'s workload) into per-device row blocks
    with the per-candidate argmin local to each device, and inserts the
    all-reduce/all-gather collectives for the few cross-shard reductions
    (adaptive match gate's global min, compaction cumsums).  Use it when one
    map is too large for a device's memory or one stream must go faster
    than one device allows.
    """

    def __init__(self, cfg: VOConfig, mesh: Mesh, seed: int = 0):
        if cfg.max_mappoints % mesh.devices.size != 0:
            raise ValueError(
                f"max_mappoints={cfg.max_mappoints} must divide evenly over "
                f"{mesh.devices.size} devices"
            )
        self.mesh = mesh
        super().__init__(cfg, seed=seed)
        axis = mesh.axis_names[0]
        specs = map_partition_specs(cfg, axis)
        shardings = jax.tree_util.tree_map(
            lambda s: NamedSharding(mesh, s),
            specs,
            is_leaf=lambda x: isinstance(x, P),
        )
        repl = NamedSharding(mesh, P())
        self._state_sharding = shardings
        self.state = jax.device_put(mapstate.init_state(cfg, seed), shardings)
        self._step = jax.jit(
            functools.partial(frontend_mod.track_step, cfg, self.camera),
            in_shardings=(shardings, repl),
            out_shardings=(shardings, repl),
            donate_argnums=0,
        )
        self._ba = jax.jit(
            functools.partial(backend_mod.ba_step, cfg, self.camera),
            in_shardings=(shardings, repl),
            out_shardings=(shardings, repl),
            donate_argnums=0,
        )


def sharded_match_descriptors(
    mesh: Mesh,
    cand_bip: jnp.ndarray,  # [C, 256] int8 - sharded along C over the mesh
    cand_mask: jnp.ndarray,  # [C] bool
    kp_bip: jnp.ndarray,  # [N, 256] int8 - replicated
    kp_mask: jnp.ndarray,  # [N] bool
    match_ratio: float = 2.0,
    min_match_distance: float = 30.0,
):
    """Tensor-parallel exact Hamming matching: candidate pool sharded across
    devices, keypoints replicated; per-row best-keypoint reductions stay
    local, and only the scalar ``min_distance`` needs a cross-device
    ``pmin``.  Returns the same MatchResult contract as
    :func:`rgbd_visualodometry_tpu.ops.matching.match_descriptors`.
    """
    from rgbd_visualodometry_tpu.ops import matching

    shard_map = jax.shard_map  # stable home since jax 0.7 (experimental path is deprecated)

    axis = mesh.axis_names[0]

    def local(cand_b, cand_m, kp_b, kp_m):
        d = matching.hamming_matrix(cand_b, kp_b)
        d = jnp.where(kp_m[None, :], d, matching.BIG)
        best_kp = jnp.argmin(d, axis=1).astype(jnp.int32)
        best_d = jnp.min(d, axis=1)
        row_ok = cand_m & (best_d < matching.BIG)
        local_min = jnp.min(jnp.where(row_ok, best_d, matching.BIG))
        # the only cross-device communication: one scalar min
        global_min = jax.lax.pmin(local_min, axis)
        max_dis = jnp.maximum(
            global_min.astype(jnp.float32) * match_ratio, min_match_distance
        )
        matched = row_ok & (best_d.astype(jnp.float32) <= max_dis)
        return matched, best_kp, best_d, global_min[None]

    matched, best_kp, best_d, gmin = shard_map(
        local,
        mesh=mesh,
        in_specs=(P(axis), P(axis), P(), P()),
        out_specs=(P(axis), P(axis), P(axis), P()),
    )(cand_bip, cand_mask, kp_bip, kp_mask)
    return matching.MatchResult(
        matched=matched, kp_index=best_kp, distance=best_d, min_distance=gmin[0]
    )
