"""GPU bring-up contracts that the CPU suite can check: the compilation
cache location, the matmul precision policy, the bench's peak table, and
that the GPU smoke run refuses to run without a GPU."""

import functools
import importlib.util
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import pytest

import __graft_entry__ as graft
from rgbd_visualodometry_tpu import mapstate
from rgbd_visualodometry_tpu.camera import Camera
from rgbd_visualodometry_tpu.ops import orb, posegraph
from rgbd_visualodometry_tpu.pipeline import backend
from rgbd_visualodometry_tpu.utils import cache
from rgbd_visualodometry_tpu.utils.precision import dot_census, implicit_float_dots

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_root_module(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_python(code, cwd, env_extra=None, drop=()):
    env = {k: v for k, v in os.environ.items() if k not in drop}
    env.update({"JAX_PLATFORMS": "cpu", "PYTHONPATH": REPO}, **(env_extra or {}))
    return subprocess.run(
        [sys.executable, "-c", code], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )


_CACHE_PROBE = (
    "import jax, jax.numpy as jnp\n"
    "from rgbd_visualodometry_tpu.utils import enable_compilation_cache\n"
    "enable_compilation_cache()\n"
    "jax.config.update('jax_persistent_cache_min_compile_time_secs', 0)\n"
    "jax.jit(lambda x: jnp.sin(x) * 3)(jnp.ones(7)).block_until_ready()\n"
    "print('CACHE_DIR=' + str(jax.config.jax_compilation_cache_dir))\n"
)


def test_cache_honours_jax_compilation_cache_dir(tmp_path):
    target = tmp_path / "jaxcache"
    proc = _run_python(
        _CACHE_PROBE, cwd=str(tmp_path),
        env_extra={"JAX_COMPILATION_CACHE_DIR": str(target)},
    )
    assert proc.returncode == 0, proc.stderr
    assert f"CACHE_DIR={target}" in proc.stdout
    assert any(target.iterdir()), "no compiled program was written to the cache"


def test_cache_defaults_to_fixed_dir_in_checkout(tmp_path):
    dirs = []
    for sub in ("a", "b"):
        cwd = tmp_path / sub
        cwd.mkdir()
        proc = _run_python(_CACHE_PROBE, cwd=str(cwd), drop=("JAX_COMPILATION_CACHE_DIR",))
        assert proc.returncode == 0, proc.stderr
        dirs.append(proc.stdout.split("CACHE_DIR=")[1].strip())
    assert dirs[0] == dirs[1] == cache.DEFAULT_CACHE_DIR
    assert os.path.dirname(cache.DEFAULT_CACHE_DIR) == REPO
    with open(os.path.join(REPO, ".gitignore"), encoding="utf-8") as f:
        ignored = {line.strip().rstrip("/") for line in f}
    assert os.path.basename(cache.DEFAULT_CACHE_DIR) in ignored


def _small_programs():
    cfg = graft._small_cfg()
    camera = Camera.from_config(cfg)
    state = mapstate.init_state(cfg)
    track, (st, frame) = graft.entry()
    gray = jnp.zeros((cfg.image_height, cfg.image_width), jnp.float32)
    poses = jnp.tile(jnp.asarray([1.0, 0, 0, 0, 0, 0, 0], jnp.float32), (6, 1))
    return {
        "track_step": (track, (st, frame)),
        "ba_step_f32": (
            functools.partial(backend.ba_step, cfg, camera), (state, jnp.int32(0))
        ),
        "orb_extract": (
            functools.partial(orb.extract, nfeatures=64, nlevels=2), (gray,)
        ),
        "pose_graph": (
            functools.partial(posegraph.optimize_pose_graph, num_iterations=2),
            (poses, posegraph.odometry_edges(poses)),
        ),
    }


@pytest.mark.parametrize(
    "name", ["track_step", "ba_step_f32", "orb_extract", "pose_graph"]
)
def test_no_float_matmul_at_default_precision(name):
    """Every f32 matmul states Precision.HIGHEST (no TF32 on the GPU).  The
    CPU backend runs no bf16 product: ORB's bf16-by-design matmuls are
    accelerator-only, and the BA normal equations are f32 everywhere."""
    fn, args = _small_programs()[name]
    census = dot_census(fn, *args)
    assert census, f"{name}: no dot_general traced"
    assert not implicit_float_dots(census), dict(census)
    assert not any(dtype == "bfloat16" for dtype, _ in census), dict(census)


def test_dot_census_flags_default_precision():
    def f(a, b):
        return a @ b, jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST)

    x = jnp.ones((4, 4), jnp.float32)
    census = dot_census(f, x, x)
    assert implicit_float_dots(census) == {("float32", "None"): 1}
    assert census[("float32", "HIGHEST")] == 1


@pytest.mark.parametrize(
    "kind,peak", [("NVIDIA H100 80GB HBM3", 989.0), ("NVIDIA H100 PCIe", 756.0)]
)
def test_bench_peak_lookup_h100(kind, peak):
    assert _load_root_module("bench").peak_bf16_tflops(kind) == peak


@pytest.mark.parametrize("kind", ["cpu", "Unknown Accelerator", "NVIDIA A100-SXM4-80GB"])
def test_bench_peak_lookup_unknown_kind_raises(kind):
    with pytest.raises(ValueError, match="no published bf16 peak"):
        _load_root_module("bench").peak_bf16_tflops(kind)


def test_chip_smoke_refuses_without_gpu(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py")],
        cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert "no GPU" in proc.stderr
