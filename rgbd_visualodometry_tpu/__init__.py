"""RGB-D visual odometry on an accelerator, in JAX.

A ground-up JAX/XLA re-design of the capabilities of the reference C++
RGB-D VO (BowenBZ/RGBD_VisualOdometry):

- ORB feature frontend (pyramid / FAST-9 / orientation / rBRIEF) as fused,
  statically-shaped XLA programs instead of ``cv::ORB``
  (reference ``src/frontend.cpp:35-37``).
- Exact Hamming descriptor matching as an int8 matmul instead of
  FLANN-LSH (reference ``src/frontend.cpp:33,187``).
- Lane-parallel RANSAC pose hypotheses instead of sequential
  ``cv::solvePnPRansac`` (reference ``src/frontend.cpp:238-241``).
- Batched Levenberg-Marquardt on the SE(3) manifold replacing g2o
  (reference ``include/myslam/g2o_types.h``, ``src/backend.cpp``).
- The whole world state (keyframes, mappoints, observations, covisibility)
  is one fixed-capacity immutable pytree threaded through a jitted step
  function - no singletons, no mutexes
  (replaces ``src/mapmanager.cpp``, ``src/frame.cpp``, ``src/mappoint.cpp``).

Matmul numerics (f32 at HIGHEST, bf16 by design, int8 exact) are one
policy, documented and audited in :mod:`rgbd_visualodometry_tpu.utils.precision`.
"""

from rgbd_visualodometry_tpu.config import VOConfig, load_config
from rgbd_visualodometry_tpu.camera import Camera

__all__ = ["VOConfig", "load_config", "Camera"]
__version__ = "0.1.0"
