"""Single-stream local-BA cost ablation at the bench preset.

Runs the EXACT ``bench.bench_single`` protocol (same windows, same data
anchors) twice - full VO vs ``enable_local_optimization=False`` - and
prints both numbers plus the BA share of steady-state frame time.  If the
share is large, overlapping BA (fork state, solve on the copy, merge at the
keyframe boundary - the reference's latest-wins contract,
``include/myslam/backend.h:33-37``) is the next lever.

Artifact: ``benchmarks/ablate_r5_ba.json`` (git-ignored).
"""
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bench
from rgbd_visualodometry_tpu.config import VOConfig
from rgbd_visualodometry_tpu.utils import enable_compilation_cache


def main():
    enable_compilation_cache()
    full = bench.bench_single(VOConfig(), repeats=3)
    print(f"full VO      : median {full['median']:.2f} / best {full['best']:.2f} FPS",
          flush=True)
    noba = bench.bench_single(
        VOConfig(enable_local_optimization=False), repeats=3
    )
    print(f"no-BA (front): median {noba['median']:.2f} / best {noba['best']:.2f} FPS",
          flush=True)
    # BA share of the steady-state frame budget, by median window FPS
    share = (1.0 - full["median"] / noba["median"]) if noba["median"] else 0.0
    rec = {
        "preset": "bench.single_stream_cfg (official single-stream phase)",
        "full_vo_fps_median": round(full["median"], 2),
        "full_vo_fps_best": round(full["best"], 2),
        "no_ba_fps_median": round(noba["median"], 2),
        "no_ba_fps_best": round(noba["best"], 2),
        "ba_share_of_frame_time": round(share, 4),
        "windows_full": full["windows"],
        "windows_no_ba": noba["windows"],
    }
    out = os.path.join(os.path.dirname(os.path.abspath(__file__)), "ablate_r5_ba.json")
    with open(out, "w", encoding="utf-8") as f:
        json.dump(rec, f, indent=1)
    print(json.dumps({k: v for k, v in rec.items() if not k.startswith("windows")}))


if __name__ == "__main__":
    main()
