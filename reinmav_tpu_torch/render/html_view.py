"""Interactive HTML trajectory animation — the live-viewer replacement.

The counterpart of :mod:`reinmav_tpu.render.html_view`.  The reference
ships three interactive viewers: a vpython browser canvas for the 3D quad
(``quadrotor3d.py:187-307``), a gym classic_control window for 2D
(``quadrotor2d.py:154-185``), and the MuJoCo viewer
(``mujoco_quad.py:74-77``), none of which runs on a host without a
display.  The vpython approach (render in the browser) is the right
idea: this module writes a SELF-CONTAINED ``.html`` file (inline JS +
canvas, no external assets, no server) that animates a recorded
trajectory with play/pause/scrub/speed controls.  Open it in any
browser, or embed in a notebook via ``IPython.display.HTML``.

Scene content mirrors the vpython one: the X-configuration quad body
(attitude-rotated arms + rotor discs), body axes, the flown path trail,
the reference/target marker, a ground grid — plus the tether and load
for the slungload envs — in an isometric 3D projection (2D envs get the
side view).  The page is byte for byte the JAX package's for the same
states.
"""

from __future__ import annotations

import json

import numpy as np

from .plot import _quat_to_rotmat, host


def _kind(env_name: str) -> str:
    if "2d" in env_name:
        return "slung2d" if "slungload" in env_name else "quad2d"
    if env_name == "reinmav-v0":
        return "reinmav"
    if env_name.startswith("MujocoQuad"):
        return "tpuquad"
    return "slung3d" if "slungload" in env_name else "quad3d"


def _frames_3d(kind: str, states: np.ndarray):
    """Per-frame dicts for 3D envs: pos, body rot matrix (row-major),
    optional load pos."""
    frames = []
    for s in states:
        if kind == "reinmav":
            pos, quat, load = s[0:3], s[6:10], None
        else:  # quad3d / tpuquad / slung3d share [pos3, quat4, ...]
            pos, quat = s[0:3], s[3:7]
            load = s[10:13] if kind == "slung3d" else None
        R = _quat_to_rotmat(np.asarray(quat, float))
        frames.append({
            "p": [round(float(v), 4) for v in pos],
            "R": [round(float(v), 4) for v in R.ravel()],
            **({"l": [round(float(v), 4) for v in load]} if load is not None else {}),
        })
    return frames


def _frames_2d(kind: str, states: np.ndarray):
    """2D envs: [x, z, theta, vx, vz] (+ [lx, lz, lvx, lvz] slung)."""
    frames = []
    for s in states:
        if kind == "quad2d":
            frames.append({"p": [round(float(s[0]), 4), round(float(s[1]), 4)],
                           "th": round(float(s[2]), 4)})
        else:  # slung2d: load position at 5:7
            frames.append({"p": [round(float(s[0]), 4), round(float(s[1]), 4)],
                           "th": round(float(s[2]), 4),
                           "l": [round(float(s[5]), 4), round(float(s[6]), 4)]})
    return frames


_PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>{title}</title><style>
body {{ background:#111; color:#ddd; font-family:monospace; margin:16px; }}
canvas {{ background:#181818; border:1px solid #333; }}
.bar {{ margin:8px 0; }} input[type=range] {{ width:420px; vertical-align:middle; }}
button {{ background:#333; color:#ddd; border:1px solid #555; padding:2px 12px; }}
</style></head><body>
<div>{title} — {nframes} frames (dt={dt}s)</div>
<canvas id="c" width="720" height="540"></canvas>
<div class="bar">
<button id="play">pause</button>
<input id="scrub" type="range" min="0" max="{maxframe}" value="0">
<span id="t"></span> speed <input id="speed" type="range" min="-2" max="2" step="1" value="0" style="width:80px">
</div>
<script>
const FRAMES = {frames_json};
const MODE = "{mode}"; const TARGET = {target_json}; const DT = {dt};
const cv = document.getElementById('c'), ctx = cv.getContext('2d');
const W = cv.width, H = cv.height;
let fi = 0, playing = true, speed = 1;
const EXT = {extent};
function proj(x, y, z) {{   // isometric 3D -> screen (2D mode: x=x, z=y)
  if (MODE === '2d') return [W/2 + x*(W/(2.2*EXT)), H*0.82 - z*(H/(1.3*EXT))];
  const c30 = 0.866, s30 = 0.5;
  const sx = (x - y) * c30, sy = (x + y) * s30 - z;
  return [W/2 + sx*(W/(3.2*EXT)), H*0.62 + sy*(H/(3.2*EXT))];
}}
function line(a, b, color, w) {{ ctx.strokeStyle=color; ctx.lineWidth=w||1.5;
  ctx.beginPath(); ctx.moveTo(a[0],a[1]); ctx.lineTo(b[0],b[1]); ctx.stroke(); }}
function dot(a, r, color) {{ ctx.fillStyle=color; ctx.beginPath();
  ctx.arc(a[0],a[1],r,0,6.2832); ctx.fill(); }}
function rotp(R, v) {{ return [R[0]*v[0]+R[1]*v[1]+R[2]*v[2],
  R[3]*v[0]+R[4]*v[1]+R[5]*v[2], R[6]*v[0]+R[7]*v[1]+R[8]*v[2]]; }}
function draw() {{
  ctx.clearRect(0,0,W,H);
  if (MODE !== '2d') {{  // ground grid
    for (let g=-2; g<=2; g++) {{
      line(proj(g,-2,0), proj(g,2,0), '#242424');
      line(proj(-2,g,0), proj(2,g,0), '#242424');
    }}
  }} else line(proj(-EXT,0,0), proj(EXT,0,0), '#242424', 2);
  // path trail
  ctx.strokeStyle='#2a6'; ctx.lineWidth=1; ctx.beginPath();
  for (let i=0; i<=fi; i++) {{
    const f=FRAMES[i]; const p=(MODE==='2d')?proj(f.p[0],0,f.p[1]):proj(f.p[0],f.p[1],f.p[2]);
    if (i===0) ctx.moveTo(p[0],p[1]); else ctx.lineTo(p[0],p[1]);
  }}
  ctx.stroke();
  if (TARGET) dot((MODE==='2d')?proj(TARGET[0],0,TARGET[1]):proj(TARGET[0],TARGET[1],TARGET[2]), 4, '#d44');
  const f = FRAMES[fi];
  if (MODE === '2d') {{
    const c=Math.cos(f.th), s=Math.sin(f.th), L=0.25;
    const p0=proj(f.p[0]-L*c, 0, f.p[1]-L*s), p1=proj(f.p[0]+L*c, 0, f.p[1]+L*s);
    line(p0, p1, '#6af', 4); dot(p0,4,'#999'); dot(p1,4,'#999');
    if (f.l) {{ const lp=proj(f.l[0],0,f.l[1]);
      line(proj(f.p[0],0,f.p[1]), lp, '#a84'); dot(lp, 5, '#ea4'); }}
  }} else {{
    const arms=[[0.35,0.35,0],[0.35,-0.35,0],[-0.35,-0.35,0],[-0.35,0.35,0]];
    const ctr=proj(f.p[0],f.p[1],f.p[2]);
    for (const a of arms) {{
      const w=rotp(f.R,a);
      const tip=proj(f.p[0]+w[0], f.p[1]+w[1], f.p[2]+w[2]);
      line(ctr, tip, '#6af', 3); dot(tip, 5, '#89b');
    }}
    const ax=[[0.5,0,0,'#d44'],[0,0.5,0,'#4d4'],[0,0,0.5,'#44e']];
    for (const a of ax) {{
      const w=rotp(f.R,[a[0],a[1],a[2]]);
      line(ctr, proj(f.p[0]+w[0], f.p[1]+w[1], f.p[2]+w[2]), a[3], 1.5);
    }}
    if (f.l) {{ const lp=proj(f.l[0],f.l[1],f.l[2]);
      line(ctr, lp, '#a84'); dot(lp, 6, '#ea4'); }}
    dot(ctr, 4, '#fff');
  }}
  document.getElementById('t').textContent =
    ' t=' + (fi*DT).toFixed(2) + 's';
  document.getElementById('scrub').value = fi;
}}
function tick() {{
  if (playing) {{ fi = (fi + speed + FRAMES.length) % FRAMES.length; draw(); }}
  setTimeout(tick, 1000*DT);
}}
document.getElementById('play').onclick = function() {{
  playing = !playing; this.textContent = playing ? 'pause' : 'play'; }};
document.getElementById('scrub').oninput = function() {{
  fi = +this.value; playing = false;
  document.getElementById('play').textContent='play'; draw(); }};
document.getElementById('speed').oninput = function() {{
  speed = Math.pow(2, +this.value); }};
draw(); tick();
</script></body></html>
"""


def save_html(env_name: str, states: np.ndarray, path: str,
              dt: float = 0.02, every: int = 1, extent: float = 3.0) -> str:
    """Write a self-contained interactive animation of ``states``
    ((T, D) trajectory) to ``path``; returns the path.

    ``dt``: playback seconds per frame (the envs' control period);
    ``every``: frame subsampling; ``extent``: scene half-width (m).
    """
    states = host(states)[::max(1, every)]
    kind = _kind(env_name)
    if kind in ("quad3d", "tpuquad", "slung3d", "reinmav"):
        frames, mode = _frames_3d(kind, states), "3d"
        target = {
            "quad3d": [0.0, 0.0, 2.0],
            "tpuquad": [0.0, 0.0, 1.0],
            "slung3d": [0.0, 0.0, 1.0],
            "reinmav": None,
        }[kind]
    else:
        frames, mode = _frames_2d(kind, states), "2d"
        target = [0.0, 1.5] if kind == "quad2d" else None
    html = _PAGE.format(
        title=env_name, nframes=len(frames), maxframe=len(frames) - 1,
        frames_json=json.dumps(frames, separators=(",", ":")),
        mode=mode, target_json=json.dumps(target), dt=dt * max(1, every),
        extent=extent,
    )
    if not path.endswith(".html"):
        path += ".html"
    with open(path, "w") as f:
        f.write(html)
    return path
