"""GPU timings of FAST detection and of three forms of the matching stage,
all plain XLA, plus how XLA:GPU lowers the matmul precisions the pipeline
states.

    python benchmarks/gpu_bringup_timings.py [--dump-hlo DIR]

Needs a GPU (exits non-zero otherwise).  ``--dump-hlo`` writes the
optimized HLO of each matching form and matmul variant to DIR.  Prints one
line per measurement; times are host-clock medians over repeated
dispatches of one jitted function closed by ``block_until_ready`` (compile
excluded).

1. ``fast.detect_level`` at pyramid level 0 (640x480), alone and vmapped
   over 72 images.
2. The matching stage (distance matrix + masked per-candidate argmin, i.e.
   ``nearest_keypoints*``) at the bench shape: C=16384 pool, N=512
   keypoints, batch 72 streams, in three forms: the packed pool (unpack +
   int8 matmul, ``packed_matching=True``), the dense bipolar pool
   (``packed_matching=False``), and XOR + popcount over the packed words.
   All three must agree exactly.
3. bf16 x bf16 -> f32 and f32 matmuls at the BRIEF shape and at 4096^3
   under DEFAULT and HIGHEST precision: time, the GEMM XLA chose, and
   whether the compiled HLO converts bf16 operands up to f32.
"""

from __future__ import annotations

import argparse
import os
import statistics
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from rgbd_visualodometry_tpu.ops import fast, image as im, matching  # noqa: E402

B, C, N = 72, 16384, 512


def timed(fn, *args, reps=7, inner=20):
    """Median and min seconds per call of the jitted ``fn``."""
    jax.block_until_ready(fn(*args))
    per = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(inner):
            out = fn(*args)
        jax.block_until_ready(out)
        per.append((time.perf_counter() - t0) / inner)
    return statistics.median(per), min(per)


def report(name, t):
    print(f"{name}: median {t[0] * 1e3:.4f} ms, min {t[1] * 1e3:.4f} ms", flush=True)


def gemm_lines(hlo: str):
    """The instructions that carry a matmul in optimized HLO: library
    custom-calls, Triton GEMM fusions, and plain dots left in fusions."""
    keys = ("custom_call_target", "triton", " dot(", "cublas")
    return [ln.strip()[:240] for ln in hlo.splitlines() if any(k in ln for k in keys)]


def show(name, fn, args, dump):
    hlo = fn.lower(*args).compile().as_text()
    print(f"{name} GEMM lines: {gemm_lines(hlo)[:4]}")
    if dump:
        os.makedirs(dump, exist_ok=True)
        with open(os.path.join(dump, name.replace(" ", "_") + ".hlo.txt"), "w") as f:
            f.write(hlo)


def nearest_keypoints_xor(cand_descT, kp_desc, kp_mask):
    """Matching stage over packed words: d[n, c] = sum_w popcount(kp[n, w]
    ^ cand[w, c]); same contract as ``matching.nearest_keypoints_packed``."""
    d = sum(
        jax.lax.population_count(kp_desc[:, w, None] ^ cand_descT[w, None, :]).astype(jnp.int32)
        for w in range(cand_descT.shape[0])
    )
    d = jnp.where(kp_mask[:, None], d, matching.BIG)
    return matching.NearestKeypoints(
        kp_index=jnp.argmin(d, axis=0).astype(jnp.int32), distance=jnp.min(d, axis=0)
    )


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dump-hlo", metavar="DIR")
    dump = ap.parse_args().dump_hlo
    if jax.default_backend() != "gpu":
        print(f"needs a GPU; JAX default backend is {jax.default_backend()!r}", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    print(f"card: {smi.stdout.strip().splitlines()[0]}; jax {jax.__version__}; "
          f"device_kind {jax.devices()[0].device_kind}")
    rng = np.random.default_rng(0)

    # 1. FAST detection at level 0
    quota = im.features_per_level(500, 8, 1.2)[0]
    img = jnp.asarray(rng.uniform(0, 255, (480, 640)).astype(np.float32))
    det = jax.jit(lambda g: fast.detect_level(g, 20.0, 31, quota))
    report(f"fast.detect_level 640x480 topk={quota}", timed(det, img))
    imgs = jnp.asarray(rng.uniform(0, 255, (B, 480, 640)).astype(np.float32))
    det_b = jax.jit(jax.vmap(lambda g: fast.detect_level(g, 20.0, 31, quota)))
    report(f"fast.detect_level 640x480 x{B} (vmapped)", timed(det_b, imgs, reps=5, inner=5))

    # 2. matching stage, three forms
    bits = rng.integers(0, 2, (B, C, 256)).astype(np.uint8)
    packed = np.packbits(bits, axis=-1, bitorder="little").view(np.uint32)  # [B, C, 8]
    bip = (bits.astype(np.int8) * 2 - 1).astype(np.int8)
    kp_bits = bits[:, :N].copy()
    kp_bits[:, :, :5] ^= 1
    kp_packed = np.packbits(kp_bits, axis=-1, bitorder="little").view(np.uint32)  # [B, N, 8]
    kp_bip = (kp_bits.astype(np.int8) * 2 - 1).astype(np.int8)
    kp_mask = jnp.asarray(rng.random((B, N)) < 0.9)
    packedT = jnp.asarray(np.ascontiguousarray(packed.transpose(0, 2, 1)))
    kp_bip, kp_packed, bip = jnp.asarray(kp_bip), jnp.asarray(kp_packed), jnp.asarray(bip)

    f_packed = jax.jit(jax.vmap(matching.nearest_keypoints_packed))
    f_dense = jax.jit(jax.vmap(matching.nearest_keypoints))
    f_xor = jax.jit(jax.vmap(nearest_keypoints_xor))
    r_p = f_packed(packedT, kp_bip, kp_mask)
    r_d = f_dense(bip, kp_bip, kp_mask)
    r_x = f_xor(packedT, kp_packed, kp_mask)
    for r in (r_d, r_x):
        assert np.array_equal(np.asarray(r.distance), np.asarray(r_p.distance))
        assert np.array_equal(np.asarray(r.kp_index), np.asarray(r_p.kp_index))
    print("matching forms agree exactly (distance and argmin)")
    shape = f"C={C} N={N} batch {B}"
    report(
        f"matching packed (unpack + int8 matmul) {shape}",
        timed(f_packed, packedT, kp_bip, kp_mask),
    )
    report(f"matching dense bipolar pool {shape}", timed(f_dense, bip, kp_bip, kp_mask))
    report(f"matching xor + popcount {shape}", timed(f_xor, packedT, kp_packed, kp_mask))
    show("matching packed", f_packed, (packedT, kp_bip, kp_mask), dump)
    show("matching dense", f_dense, (bip, kp_bip, kp_mask), dump)
    show("matching xor", f_xor, (packedT, kp_packed, kp_mask), dump)

    # 3. matmul precision lowering: the BRIEF shape, and 4096^3 where TF32
    # and full f32 differ ~8x in tensor-core rate
    for m, k, n in ((500, 560, 1536), (4096, 4096, 4096)):
        a32 = jnp.asarray(rng.standard_normal((m, k)).astype(np.float32))
        b32 = jnp.asarray(rng.standard_normal((k, n)).astype(np.float32))
        for dt in (jnp.bfloat16, jnp.float32):
            for prec in (jax.lax.Precision.DEFAULT, jax.lax.Precision.HIGHEST):
                f = jax.jit(lambda x, y, p=prec: jax.lax.dot_general(
                    x, y, (((1,), (0,)), ((), ())), precision=p,
                    preferred_element_type=jnp.float32))
                x, y = a32.astype(dt), b32.astype(dt)
                name = f"dot {m}x{k}x{n} {np.dtype(dt).name} {prec.name}"
                txt = f.lower(x, y).compile().as_text()
                up = dt == jnp.bfloat16 and "f32" in "".join(
                    ln for ln in txt.splitlines() if "convert(" in ln)
                show(name, f, (x, y), dump)
                report(f"{name} (bf16->f32 operand convert: {up})", timed(f, x, y))
    return 0


if __name__ == "__main__":
    sys.exit(main())
