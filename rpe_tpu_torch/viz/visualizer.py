"""Trajectory + video visualization (port of rpe_tpu/viz/visualizer.py).

The 3D plot is `orientation_plot.html`: with plotly importable, the
reference figure (plotly's own HTML); otherwise a self-contained HTML file
with a small canvas renderer (orbit drag + zoom) holding the same content
(GT path line, red GT arrows, blue EST arrows, hover labels). The annotated
video uses PIL text overlays and an imageio or cv2 encoder, all imported
only when a video is made (the card machine has none of them, and neither
run needs them otherwise).
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from ..geometry.rotations import euler_to_rotation_yup


class Visualizer:
    """The reference's Visualizer API."""

    def __init__(self, output_dir):
        self.output_dir = Path(output_dir)
        self.output_dir.mkdir(parents=True, exist_ok=True)

    # -- 3D trajectory plot --------------------------------------------------

    def plot_3d_trajectory(self, gt_trajectory_full, gt_trajectory_filtered,
                           gt_orientations_filtered, evaluation_results,
                           arrow_scale=0.3, step=15, show=False):
        """GT path + GT/EST orientation arrows -> orientation_plot.html.

        GT arrows from filtered GT orientations; EST arrows from estimated
        Euler angles, prepended with the first GT arrow (estimates start at
        the second frame).
        """
        est_roll = np.asarray(evaluation_results["est_roll"])
        est_pitch = np.asarray(evaluation_results["est_pitch"])
        est_yaw = np.asarray(evaluation_results["est_yaw"])

        dirs_gt, labels = [], []
        for i in range(len(gt_orientations_filtered)):
            roll, pitch, yaw = gt_orientations_filtered[i]
            dirs_gt.append(self._rpy_to_direction(roll, pitch, yaw) * arrow_scale)
            labels.append(f"{i * step}-{i * step + step}")
        dirs_gt = np.array(dirs_gt) if dirs_gt else np.zeros((0, 3))

        dirs_est = [self._rpy_to_direction(est_roll[i], est_pitch[i], est_yaw[i])
                    * arrow_scale for i in range(len(est_roll))]
        dirs_est = ([dirs_gt[0]] if len(dirs_gt) else []) + dirs_est
        dirs_est = np.array(dirs_est) if dirs_est else np.zeros((0, 3))

        output_path = self.output_dir / "orientation_plot.html"
        try:
            import plotly.graph_objects as go  # noqa: PLC0415

            self._plot_plotly(go, gt_trajectory_full, gt_trajectory_filtered,
                              dirs_gt, dirs_est, labels, output_path, show)
        except ImportError:
            self._plot_standalone_html(
                np.asarray(gt_trajectory_full),
                np.asarray(gt_trajectory_filtered),
                dirs_gt, dirs_est, labels, output_path)
        print(f"[INFO] 3D plot saved to: {output_path}")
        return str(output_path)

    def _plot_plotly(self, go, gt_full, gt_filt, dirs_gt, dirs_est, labels,
                     output_path, show):
        fig = go.Figure()
        gt_full = np.asarray(gt_full)
        fig.add_trace(go.Scatter3d(
            x=gt_full[:, 0], y=gt_full[:, 1], z=gt_full[:, 2],
            mode="lines", line=dict(width=5, color="red"), name="GT path"))
        for color, dirs in (("red", dirs_gt), ("blue", dirs_est)):
            for i in range(min(len(gt_filt), len(dirs))):
                x0, y0, z0 = gt_filt[i]
                dx, dy, dz = dirs[i]
                fig.add_trace(go.Scatter3d(
                    x=[x0, x0 + dx], y=[y0, y0 + dy], z=[z0, z0 + dz],
                    mode="lines", line=dict(width=4, color=color),
                    showlegend=False))
                fig.add_trace(go.Cone(
                    x=[x0 + dx], y=[y0 + dy], z=[z0 + dz],
                    u=[dx], v=[dy], w=[dz], anchor="tail",
                    colorscale=[[0, color], [1, color]],
                    sizemode="absolute", sizeref=0.15, showscale=False))
        fig.update_layout(
            scene=dict(aspectmode="cube"),
            title="GT + EST Orientation (3D view)", width=1300, height=900)
        fig.write_html(str(output_path))
        if show:
            fig.show()

    def _plot_standalone_html(self, gt_full, gt_filt, dirs_gt, dirs_est,
                              labels, output_path):
        """Zero-dependency interactive 3D viewer (canvas + orbit drag)."""
        data = {
            "path": gt_full.tolist(),
            "anchors": gt_filt.tolist(),
            "gt": dirs_gt.tolist(),
            "est": dirs_est.tolist(),
            "labels": labels,
        }
        html = _STANDALONE_TEMPLATE.replace("__DATA__", json.dumps(data))
        output_path.write_text(html)

    def create_video(self, images_dir, evaluation_results,
                     output_filename="output.mp4", fps=10):
        """Annotated video: frame number (white), GT rpy (red), EST rpy (blue)
        overlaid per evaluated frame. Needs PIL (ImportError naming it
        before any frame is read) and imageio or cv2."""
        from PIL import Image, ImageDraw

        images_dir = Path(images_dir)
        frames = evaluation_results["frames"]
        gt = (evaluation_results["gt_roll"], evaluation_results["gt_pitch"],
              evaluation_results["gt_yaw"])
        est = (evaluation_results["est_roll"], evaluation_results["est_pitch"],
               evaluation_results["est_yaw"])

        first_path = images_dir / f"{frames[0]:06d}.png"
        if not first_path.exists():
            raise RuntimeError(f"Could not read first image: {first_path}")

        video_path = self.output_dir / output_filename
        writer = _open_video_writer(video_path, fps)
        print(f"[INFO] Saving video to: {video_path}")
        try:
            for i, frame_idx in enumerate(frames):
                img_path = images_dir / f"{frame_idx:06d}.png"
                if not img_path.exists():
                    print(f"[WARN] Could not read image for frame {frame_idx}, "
                          f"skipping")
                    continue
                im = Image.open(img_path).convert("RGB")
                draw = ImageDraw.Draw(im)
                draw.text((30, 40), f"Frame: {frame_idx}",
                          fill=(255, 255, 255), font_size=28)
                draw.text((30, 85),
                          f"GT   r={gt[0][i]:.1f}, p={gt[1][i]:.1f}, "
                          f"y={gt[2][i]:.1f} deg", fill=(255, 0, 0),
                          font_size=22)
                draw.text((30, 125),
                          f"EST  r={est[0][i]:.1f}, p={est[1][i]:.1f}, "
                          f"y={est[2][i]:.1f} deg", fill=(0, 0, 255),
                          font_size=22)
                writer.append(np.asarray(im))
        finally:
            writer.close()
        print(f"[INFO] Video saved to: {video_path}")
        return str(video_path)

    @staticmethod
    def _rpy_to_direction(roll_deg, pitch_deg, yaw_deg):
        """Forward-direction arrow from rpy: R_yup @ [0,0,1], negated,
        normalized (R in float32, as the reference computes it)."""
        R = euler_to_rotation_yup(yaw_deg, pitch_deg, roll_deg).numpy()
        direction = -(R @ np.array([0.0, 0.0, 1.0]))
        return direction / np.linalg.norm(direction)


class _ImageioWriter:
    def __init__(self, path, fps):
        import imageio

        self._w = imageio.get_writer(str(path), fps=fps)

    def append(self, frame):
        self._w.append_data(frame)

    def close(self):
        self._w.close()


class _Cv2Writer:
    def __init__(self, path, fps, size):
        import cv2

        fourcc = cv2.VideoWriter_fourcc(*"mp4v")
        self._w = cv2.VideoWriter(str(path), fourcc, fps, size)
        self._cv2 = cv2

    def append(self, frame):
        self._w.write(frame[..., ::-1])  # RGB -> BGR

    def close(self):
        self._w.release()


class _LazyVideoWriter:
    """Opens the backend on the first frame (cv2 needs the frame size)."""

    def __init__(self, path, fps):
        self.path, self.fps, self._w = path, fps, None

    def append(self, frame):
        if self._w is None:
            try:
                self._w = _ImageioWriter(self.path, self.fps)
            except Exception:
                self._w = _Cv2Writer(self.path, self.fps,
                                     (frame.shape[1], frame.shape[0]))
        self._w.append(frame)

    def close(self):
        if self._w is not None:
            self._w.close()


def _open_video_writer(path, fps):
    return _LazyVideoWriter(path, fps)


_STANDALONE_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>GT + EST Orientation (3D view)</title>
<style>body{margin:0;font-family:sans-serif;background:#fff}
#c{display:block}#hud{position:fixed;top:8px;left:8px;color:#333;font-size:13px}
#tip{position:fixed;display:none;background:rgba(0,0,60,.85);color:#fff;
padding:2px 6px;border-radius:3px;font-size:12px;pointer-events:none}</style>
</head><body>
<div id="hud">GT + EST Orientation — drag to orbit, wheel to zoom.
<span style="color:red">red = GT</span>,
<span style="color:blue">blue = EST</span></div>
<div id="tip"></div><canvas id="c"></canvas>
<script>
const DATA = __DATA__;
const cv = document.getElementById('c'), ctx = cv.getContext('2d');
const tip = document.getElementById('tip');
let W,H; function rs(){W=cv.width=innerWidth;H=cv.height=innerHeight;draw();}
addEventListener('resize',rs);
let az=0.9, el=0.5, zoom=1.0;
const all = DATA.path.concat(DATA.anchors);
let cx=0,cy=0,cz=0,r=1;
if(all.length){
  const mn=[1e9,1e9,1e9],mx=[-1e9,-1e9,-1e9];
  for(const p of all)for(let k=0;k<3;k++){mn[k]=Math.min(mn[k],p[k]);mx[k]=Math.max(mx[k],p[k]);}
  cx=(mn[0]+mx[0])/2;cy=(mn[1]+mx[1])/2;cz=(mn[2]+mx[2])/2;
  r=Math.max(mx[0]-mn[0],mx[1]-mn[1],mx[2]-mn[2],1e-6)*0.75;
}
function proj(p){
  const x=p[0]-cx,y=p[1]-cy,z=p[2]-cz;
  const ca=Math.cos(az),sa=Math.sin(az),ce=Math.cos(el),se=Math.sin(el);
  const x1=ca*x+sa*z, z1=-sa*x+ca*z;
  const y2=ce*y-se*z1, z2=se*y+ce*z1;
  const s=Math.min(W,H)*0.45*zoom/r;
  return [W/2+x1*s, H/2-y2*s, z2];
}
let hot=[];
function arrow(a,d,color,label){
  const p0=proj(a), p1=proj([a[0]+d[0],a[1]+d[1],a[2]+d[2]]);
  ctx.strokeStyle=color;ctx.lineWidth=2.2;
  ctx.beginPath();ctx.moveTo(p0[0],p0[1]);ctx.lineTo(p1[0],p1[1]);ctx.stroke();
  const dx=p1[0]-p0[0],dy=p1[1]-p0[1],L=Math.hypot(dx,dy)||1;
  const ux=dx/L,uy=dy/L;
  ctx.fillStyle=color;ctx.beginPath();
  ctx.moveTo(p1[0],p1[1]);
  ctx.lineTo(p1[0]-8*ux+4*uy,p1[1]-8*uy-4*ux);
  ctx.lineTo(p1[0]-8*ux-4*uy,p1[1]-8*uy+4*ux);
  ctx.closePath();ctx.fill();
  hot.push([p1[0],p1[1],label,color]);
}
function draw(){
  ctx.clearRect(0,0,W,H);hot=[];
  if(DATA.path.length){
    ctx.strokeStyle='red';ctx.lineWidth=2.5;ctx.beginPath();
    DATA.path.forEach((p,i)=>{const q=proj(p);i?ctx.lineTo(q[0],q[1]):ctx.moveTo(q[0],q[1]);});
    ctx.stroke();
  }
  DATA.anchors.forEach((a,i)=>{
    if(i<DATA.gt.length) arrow(a,DATA.gt[i],'red','GT '+(DATA.labels[i]||i));
    if(i<DATA.est.length) arrow(a,DATA.est[i],'blue','EST '+(DATA.labels[i]||i));
  });
}
let drag=false,px=0,py=0;
cv.onmousedown=e=>{drag=true;px=e.clientX;py=e.clientY;};
onmouseup=()=>drag=false;
onmousemove=e=>{
  if(drag){az+=(e.clientX-px)*0.01;el+=(e.clientY-py)*0.01;
    el=Math.max(-1.5,Math.min(1.5,el));px=e.clientX;py=e.clientY;draw();}
  else{let best=null,bd=144;
    for(const h of hot){const d=(h[0]-e.clientX)**2+(h[1]-e.clientY)**2;
      if(d<bd){bd=d;best=h;}}
    if(best){tip.style.display='block';tip.style.left=(e.clientX+12)+'px';
      tip.style.top=(e.clientY+12)+'px';tip.textContent='frames: '+best[2];
      tip.style.background=best[3]==='red'?'rgba(255,0,0,.85)':'rgba(0,0,255,.85)';}
    else tip.style.display='none';}
};
addEventListener('wheel',e=>{zoom*=e.deltaY<0?1.1:0.9;draw();});
rs();
</script></body></html>
"""
