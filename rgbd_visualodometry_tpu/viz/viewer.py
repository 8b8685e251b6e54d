"""Host-side map/trajectory viewer.

Functional replacement for the reference ``Viewer`` (``src/viewer.cpp``):
the Pangolin thread there draws (a) the current camera frustum, (b) all
mappoints as a colored point cloud (``viewer.cpp:68-86``), and (c) a
cv::imshow overlay of the current frame with matched keypoints highlighted
(``viewer.cpp:144-150``).  Here the same three views are rendered on the
host with matplotlib / numpy - a deliberate design change: the device hot loop
must never block on rendering, so visualization consumes host-side
snapshots (``VisualOdometry.map_snapshot``) instead of sharing mutex-guarded
map objects.
"""

from __future__ import annotations

import numpy as np


class MapViewer:
    """Renders map snapshots to PNG files (headless-friendly)."""

    def __init__(self, out_dir: str = "viewer_out"):
        import os

        self.out_dir = out_dir
        os.makedirs(out_dir, exist_ok=True)
        self._counter = 0

    def render_map(self, snapshot: dict, trajectory: np.ndarray | None = None, name: str | None = None) -> str:
        """Top-down + 3D view of mappoints, keyframes and trajectory.

        snapshot: output of ``VisualOdometry.map_snapshot()``;
        trajectory: optional [N, 3] camera positions (T_w_c translations).
        Returns the written file path.
        """
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        pts = snapshot["mappoints"]
        kf = snapshot["keyframe_poses"]
        fig = plt.figure(figsize=(12, 6))
        ax = fig.add_subplot(121)
        if len(pts):
            ax.scatter(pts[:, 0], pts[:, 1], s=1, c=pts[:, 2], cmap="viridis")
        if trajectory is not None and len(trajectory):
            ax.plot(trajectory[:, 0], trajectory[:, 1], "r-", lw=1.5, label="trajectory")
            # current-camera frustum in red (the DrawFrame analogue,
            # viewer.cpp:89-136), drawn for the last pose
            self._draw_frustum_2d(ax, trajectory[-1], kf)
            ax.legend()
        ax.set_xlabel("x [m]")
        ax.set_ylabel("y [m]")
        ax.set_title(f"map: {len(pts)} points, {snapshot['num_keyframes']} keyframes")
        ax.set_aspect("equal", adjustable="datalim")

        ax3 = fig.add_subplot(122, projection="3d")
        if len(pts):
            sub = pts[:: max(len(pts) // 5000, 1)]
            ax3.scatter(sub[:, 0], sub[:, 1], sub[:, 2], s=1, c=sub[:, 2], cmap="viridis")
        if trajectory is not None and len(trajectory):
            ax3.plot(trajectory[:, 0], trajectory[:, 1], trajectory[:, 2], "r-", lw=1.5)
        ax3.set_title("3D view")

        name = name or f"map_{self._counter:05d}.png"
        self._counter += 1
        path = f"{self.out_dir}/{name}"
        fig.tight_layout()
        fig.savefig(path, dpi=110)
        plt.close(fig)
        return path

    @staticmethod
    def _draw_frustum_2d(ax, cam_pos, kf_poses):
        """Project a simple frustum wedge for the current camera into the
        top-down view (direction from the latest keyframe orientation)."""
        import numpy as np

        if kf_poses is None or not len(kf_poses):
            return
        q = kf_poses[-1][:4]  # T_c_w of latest keyframe
        w, x, y, z = q
        # camera forward (+z of camera) in world = third row of R_c_w^T
        fwd = np.array(
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]
        )
        side = np.array([fwd[1], -fwd[0], 0.0])
        n = np.linalg.norm(side)
        side = side / n if n > 1e-6 else np.array([1.0, 0, 0])
        tip = np.asarray(cam_pos[:3])
        a = tip + 0.25 * fwd[:3] + 0.12 * side
        b = tip + 0.25 * fwd[:3] - 0.12 * side
        ax.plot(
            [a[0], tip[0], b[0]], [a[1], tip[1], b[1]], "r-", lw=1.0,
            label="camera",
        )

    def export_html(
        self,
        snapshot: dict,
        trajectory: np.ndarray | None = None,
        name: str = "map.html",
        edges: np.ndarray | None = None,
    ) -> str:
        """Write a self-contained INTERACTIVE 3D map viewer (orbit / zoom /
        pan with the mouse) - the headless counterpart of the reference's
        live Pangolin window (``src/viewer.cpp:16-54``: point cloud +
        camera frusta + trajectory in a rotatable GL view).  Pure
        canvas-2D JavaScript with an embedded JSON snapshot; no network,
        no external libraries - open the file in any browser.

        ``edges`` ([E, 2, 3] world segments, e.g. loop-closure constraints
        from ``globalopt.RelaxReport.loop_pairs_w``) render as green lines.
        """
        pts = np.asarray(snapshot["mappoints"], np.float32).reshape(-1, 3)
        if len(pts) > 60000:  # keep the file and the draw loop snappy
            pts = pts[:: len(pts) // 60000 + 1]
        kf = np.asarray(snapshot.get("keyframe_poses", np.zeros((0, 7))), np.float32)
        traj = (
            np.asarray(trajectory, np.float32).reshape(-1, 3)
            if trajectory is not None and len(trajectory)
            else np.zeros((0, 3), np.float32)
        )
        # keyframe camera centers + forward axes for frustum wedges
        frusta = []
        for q in kf:
            w_, x, y, z = q[:4]
            # camera center c = -R^T t; forward = R^T e_z (row 3 of R)
            R = np.array([
                [1 - 2 * (y * y + z * z), 2 * (x * y - w_ * z), 2 * (x * z + w_ * y)],
                [2 * (x * y + w_ * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w_ * x)],
                [2 * (x * z - w_ * y), 2 * (y * z + w_ * x), 1 - 2 * (x * x + y * y)],
            ])
            c = -R.T @ q[4:7]
            frusta.append(np.concatenate([c, R[2]]))
        frusta = np.asarray(frusta, np.float32).reshape(-1, 6)

        import json as _json
        import os

        def _arr(a):
            return _json.dumps(np.round(a, 4).flatten().tolist())

        seg = (
            np.asarray(edges, np.float32).reshape(-1, 6)
            if edges is not None and len(edges)
            else np.zeros((0, 6), np.float32)
        )
        html = _HTML_VIEWER_TEMPLATE % {
            "pts": _arr(pts), "traj": _arr(traj), "frusta": _arr(frusta),
            "edges": _arr(seg),
            "n_pts": len(pts), "n_kf": len(kf), "n_edges": len(seg),
        }
        path = os.path.join(self.out_dir, name)
        with open(path, "w", encoding="utf-8") as f:
            f.write(html)
        return path

    def render_overlay(
        self,
        rgb: np.ndarray,
        xy: np.ndarray,
        valid: np.ndarray | None = None,
        name: str | None = None,
    ) -> str:
        """Write the per-frame keypoint-overlay image (the live
        ``cv::imshow`` of ``viewer.cpp:44-46`` as a PNG stream)."""
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.image as mpimg

        img = self.draw_keypoints(rgb, xy, valid)
        name = name or f"frame_{self._counter:05d}.png"
        self._counter += 1
        path = f"{self.out_dir}/{name}"
        mpimg.imsave(path, img)
        return path

    @staticmethod
    def draw_keypoints(rgb: np.ndarray, xy: np.ndarray, valid: np.ndarray | None = None, radius: int = 2) -> np.ndarray:
        """Feature-overlay image (the ``PlotFrameImage`` analogue,
        ``viewer.cpp:144-150``): returns a copy of ``rgb`` with green boxes
        at keypoint locations."""
        img = np.asarray(rgb).copy()
        h, w = img.shape[:2]
        pts = np.asarray(xy)
        if valid is not None:
            pts = pts[np.asarray(valid)]
        for x, y in pts:
            xi, yi = int(round(float(x))), int(round(float(y)))
            x0, x1 = max(xi - radius, 0), min(xi + radius + 1, w)
            y0, y1 = max(yi - radius, 0), min(yi + radius + 1, h)
            img[y0:y1, x0] = (0, 255, 0)
            img[y0:y1, x1 - 1] = (0, 255, 0)
            img[y0, x0:x1] = (0, 255, 0)
            img[y1 - 1, x0:x1] = (0, 255, 0)
        return img


_HTML_VIEWER_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>rgbd_vo map viewer</title>
<style>
 body{margin:0;background:#10141a;color:#cdd6e4;font:13px sans-serif;overflow:hidden}
 #hud{position:fixed;top:8px;left:10px;pointer-events:none;opacity:.85}
 canvas{display:block;cursor:grab}
</style></head><body>
<div id="hud">map: %(n_pts)d points, %(n_kf)d keyframes, %(n_edges)d loop edges &mdash;
 drag = orbit &middot; wheel = zoom &middot; shift-drag = pan</div>
<canvas id="c"></canvas>
<script>
"use strict";
// embedded map snapshot (world coordinates, meters)
const PTS = new Float32Array(%(pts)s);
const TRAJ = new Float32Array(%(traj)s);
const FRUSTA = new Float32Array(%(frusta)s); // [cx,cy,cz, fx,fy,fz] per kf
const EDGES = new Float32Array(%(edges)s); // [ax,ay,az, bx,by,bz] loop edges
const cv = document.getElementById("c"), ctx = cv.getContext("2d");
let W, H; function resize(){W=cv.width=innerWidth;H=cv.height=innerHeight;draw();}
addEventListener("resize", resize);
// orbit-camera state: yaw/pitch around a target, distance dolly
let yaw=-0.6, pitch=0.45, dist=6, target=[0,0,2.5];
// center the view on the point-cloud centroid
if (PTS.length) {
  let s=[0,0,0]; const n=PTS.length/3;
  for (let i=0;i<PTS.length;i+=3){s[0]+=PTS[i];s[1]+=PTS[i+1];s[2]+=PTS[i+2];}
  target=[s[0]/n, s[1]/n, s[2]/n];
}
function basis(){
  const cy=Math.cos(yaw), sy=Math.sin(yaw), cp=Math.cos(pitch), sp=Math.sin(pitch);
  // camera axes in world space (right, up, forward)
  const fwd=[cp*sy, -sp, cp*cy];
  const right=[cy, 0, -sy];
  const up=[sy*sp, cp, cy*sp];
  const eye=[target[0]-dist*fwd[0], target[1]-dist*fwd[1], target[2]-dist*fwd[2]];
  return {right, up, fwd, eye};
}
function project(p, B){
  const dx=p[0]-B.eye[0], dy=p[1]-B.eye[1], dz=p[2]-B.eye[2];
  const z=dx*B.fwd[0]+dy*B.fwd[1]+dz*B.fwd[2];
  if (z<0.05) return null;
  const x=dx*B.right[0]+dy*B.right[1]+dz*B.right[2];
  const y=dx*B.up[0]+dy*B.up[1]+dz*B.up[2];
  const f=0.9*Math.min(W,H);
  return [W/2+f*x/z, H/2-f*y/z, z];
}
function depthColor(t){ // viridis-ish 3-stop ramp on normalized depth
  t=Math.max(0,Math.min(1,t));
  const r=Math.round(68+t*(253-68)*t), g=Math.round(84+t*140), b=Math.round(140-t*60+((1-t)*50));
  return `rgb(${r},${g},${b})`;
}
let zmin=1e9, zmax=-1e9;
for (let i=2;i<PTS.length;i+=3){ if(PTS[i]<zmin)zmin=PTS[i]; if(PTS[i]>zmax)zmax=PTS[i]; }
function draw(){
  const B=basis();
  ctx.fillStyle="#10141a"; ctx.fillRect(0,0,W,H);
  // mappoints
  for (let i=0;i<PTS.length;i+=3){
    const s=project([PTS[i],PTS[i+1],PTS[i+2]],B);
    if(!s) continue;
    ctx.fillStyle=depthColor((PTS[i+2]-zmin)/(zmax-zmin+1e-9));
    const r=Math.max(0.7, 2.2/s[2]);
    ctx.fillRect(s[0]-r/2, s[1]-r/2, r, r);
  }
  // trajectory polyline (red, like the reference's current-frustum color)
  if (TRAJ.length>=6){
    ctx.strokeStyle="#ff5252"; ctx.lineWidth=1.6; ctx.beginPath();
    let started=false;
    for (let i=0;i<TRAJ.length;i+=3){
      const s=project([TRAJ[i],TRAJ[i+1],TRAJ[i+2]],B);
      if(!s){started=false;continue;}
      if(started) ctx.lineTo(s[0],s[1]); else {ctx.moveTo(s[0],s[1]); started=true;}
    }
    ctx.stroke();
  }
  // loop-closure constraint edges (green chords between keyframe centers)
  if (EDGES.length>=6){
    ctx.strokeStyle="#69f0ae"; ctx.lineWidth=1.2;
    for (let i=0;i<EDGES.length;i+=6){
      const a=project([EDGES[i],EDGES[i+1],EDGES[i+2]],B);
      const b=project([EDGES[i+3],EDGES[i+4],EDGES[i+5]],B);
      if(!a||!b) continue;
      ctx.beginPath(); ctx.moveTo(a[0],a[1]); ctx.lineTo(b[0],b[1]); ctx.stroke();
    }
  }
  // keyframe frusta: short wedge along each camera's forward axis
  ctx.strokeStyle="#64b5f6"; ctx.lineWidth=1;
  for (let i=0;i<FRUSTA.length;i+=6){
    const c=[FRUSTA[i],FRUSTA[i+1],FRUSTA[i+2]];
    const f=[FRUSTA[i+3],FRUSTA[i+4],FRUSTA[i+5]];
    const tip=project(c,B);
    const end=project([c[0]+0.12*f[0], c[1]+0.12*f[1], c[2]+0.12*f[2]],B);
    if(!tip||!end) continue;
    ctx.beginPath(); ctx.moveTo(tip[0],tip[1]); ctx.lineTo(end[0],end[1]); ctx.stroke();
    ctx.strokeRect(tip[0]-2, tip[1]-2, 4, 4);
  }
}
let drag=null;
cv.addEventListener("mousedown", e=>{drag=[e.clientX,e.clientY,e.shiftKey];cv.style.cursor="grabbing";});
addEventListener("mouseup", ()=>{drag=null;cv.style.cursor="grab";});
addEventListener("mousemove", e=>{
  if(!drag) return;
  const dx=e.clientX-drag[0], dy=e.clientY-drag[1];
  if (drag[2]){ // pan in the view plane
    const B=basis(), k=dist/(0.9*Math.min(W,H));
    target=[target[0]-k*(dx*B.right[0]-dy*B.up[0]),
            target[1]-k*(dx*B.right[1]-dy*B.up[1]),
            target[2]-k*(dx*B.right[2]-dy*B.up[2])];
  } else { yaw+=dx*0.008; pitch=Math.max(-1.5,Math.min(1.5,pitch+dy*0.008)); }
  drag=[e.clientX,e.clientY,drag[2]]; draw();
});
cv.addEventListener("wheel", e=>{e.preventDefault(); dist*=Math.exp(e.deltaY*0.0012); dist=Math.max(0.3,Math.min(80,dist)); draw();},{passive:false});
resize();
</script></body></html>
"""
