"""LIVE while-stepping browser viewer.

The counterpart of :mod:`reinmav_tpu.render.live_view`.  The reference
renders DURING the rollout: a vpython browser canvas updated from
``env.render()`` inside the step loop
(``gym_reinmav/envs/native/quadrotor3d.py:187-307``).  vpython's trick —
the python process serves a page and streams geometry to it — works on
a host without a display too, so this module does exactly that with the
standard library only: a background ``ThreadingHTTPServer`` serves a
self-contained canvas page (the same scene drawing as
:mod:`.html_view`) that polls ``/frames.json``; the play loop pushes each
state as it is stepped.  Open the printed URL in a browser (``ssh -L``
port-forward if the host is remote — the server binds loopback by
default; pass ``host="0.0.0.0"`` to expose it deliberately).  The URL is
built from the address the server bound.

Usage (the CLI wires this as ``--play --live``)::

    viewer = LiveViewer("quadrotor3d-v0")
    print("watch at", viewer.url)
    for ...:
        out = env.step(s, policy(s))
        viewer.push(out.obs)
    viewer.close()
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .html_view import _frames_2d, _frames_3d, _kind
from .plot import host

#: Bounded trail so an unbounded play loop cannot grow memory forever.
MAX_FRAMES = 4000

_LIVE_PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>{title} (live)</title><style>
body {{ background:#111; color:#ddd; font-family:monospace; margin:16px; }}
canvas {{ background:#181818; border:1px solid #333; }}
</style></head><body>
<div>{title} — LIVE <span id="st">connecting…</span></div>
<canvas id="c" width="720" height="540"></canvas>
<script>
const MODE = "{mode}"; const TARGET = {target_json}; const DT = {dt};
let FRAMES = []; let seq = -1; let live = true;
const cv = document.getElementById('c'), ctx = cv.getContext('2d');
const W = cv.width, H = cv.height;
const EXT = {extent};
function proj(x, y, z) {{
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
  if (!FRAMES.length) return;
  ctx.clearRect(0,0,W,H);
  if (MODE !== '2d') {{
    for (let g=-2; g<=2; g++) {{
      line(proj(g,-2,0), proj(g,2,0), '#242424');
      line(proj(-2,g,0), proj(2,g,0), '#242424');
    }}
  }} else line(proj(-EXT,0,0), proj(EXT,0,0), '#242424', 2);
  ctx.strokeStyle='#2a6'; ctx.lineWidth=1; ctx.beginPath();
  for (let i=0; i<FRAMES.length; i++) {{
    const f=FRAMES[i]; const p=(MODE==='2d')?proj(f.p[0],0,f.p[1]):proj(f.p[0],f.p[1],f.p[2]);
    if (i===0) ctx.moveTo(p[0],p[1]); else ctx.lineTo(p[0],p[1]);
  }}
  ctx.stroke();
  if (TARGET) dot((MODE==='2d')?proj(TARGET[0],0,TARGET[1]):proj(TARGET[0],TARGET[1],TARGET[2]), 4, '#d44');
  const f = FRAMES[FRAMES.length-1];
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
      line(ctr, proj(f.p[0]+w[0], f.p[1]+w[1], f.p[2]+w[2]), '#6af', 3);
    }}
    if (f.l) {{ const lp=proj(f.l[0],f.l[1],f.l[2]);
      line(ctr, lp, '#a84'); dot(lp, 6, '#ea4'); }}
    dot(ctr, 4, '#fff');
  }}
}}
async function poll() {{
  try {{
    const r = await fetch('/frames.json?since=' + seq);
    const j = await r.json();
    if (j.seq !== seq) {{
      if (j.base > seq) FRAMES = j.frames;   // gap: server trail wrapped
      else FRAMES.push(...j.frames);
      if (FRAMES.length > 4000) FRAMES.splice(0, FRAMES.length - 4000);
      seq = j.seq; draw();
    }}
    document.getElementById('st').textContent =
      j.done ? '(rollout finished — ' + j.seq + ' frames)' : 't=' + (j.seq*DT).toFixed(2) + 's';
  }} catch (e) {{
    document.getElementById('st').textContent = '(viewer disconnected)';
    live = false;
  }}
  if (live) setTimeout(poll, Math.max(30, 1000*DT));
}}
poll();
</script></body></html>
"""


class LiveViewer:
    """Serve a live view of a stepping rollout on ``http://host:port``
    (:attr:`url`, from the address the server bound).

    ``push(state)`` is called from the play loop with the flat env
    state/obs vector; the page polls and redraws.  Thread-safe; the
    server runs on a daemon thread and dies with the process (or call
    :meth:`close`)."""

    def __init__(self, env_name: str, port: int = 0, host: str = "127.0.0.1",
                 dt: float = 0.02, extent: float = 3.0):
        self.env_name = env_name
        self._dt = dt
        kind = _kind(env_name)
        self._kind = kind
        self._mode = "2d" if kind in ("quad2d", "slung2d") else "3d"
        target = {
            "quad3d": [0.0, 0.0, 2.0], "tpuquad": [0.0, 0.0, 1.0],
            "slung3d": [0.0, 0.0, 1.0], "reinmav": None,
            "quad2d": [0.0, 1.5], "slung2d": None,
        }[kind]
        self._page = _LIVE_PAGE.format(
            title=env_name, mode=self._mode,
            target_json=json.dumps(target), dt=dt, extent=extent,
        ).encode()
        self._lock = threading.Lock()
        self._frames: list = []
        self._seq = 0
        self._done = False

        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # silence per-request stderr spam
                pass

            def do_GET(self):
                if self.path.startswith("/frames.json"):
                    since = -1
                    if "since=" in self.path:
                        try:
                            since = int(self.path.split("since=")[1]
                                        .split("&")[0])
                        except ValueError:
                            pass
                    # Copy the NEW slice under the lock, serialize outside
                    # it — a full-trail dump per poll would both stall the
                    # play loop's push() and ship redundant data.
                    with viewer._lock:
                        seq, done = viewer._seq, viewer._done
                        count = min(len(viewer._frames), max(0, seq - since))
                        frames = viewer._frames[-count:] if count else []
                    body = json.dumps({
                        "seq": seq, "base": seq - count, "done": done,
                        "frames": frames,
                    }, separators=(",", ":")).encode()
                    ctype = "application/json"
                elif self.path == "/" or self.path.startswith("/index"):
                    body, ctype = viewer._page, "text/html"
                else:
                    self.send_response(404)
                    self.end_headers()
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self._server = ThreadingHTTPServer((host, port), Handler)
        bound_host, self.port = self._server.server_address[:2]
        if ":" in bound_host:  # an IPv6 literal
            bound_host = f"[{bound_host}]"
        self.url = f"http://{bound_host}:{self.port}/"
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True)
        self._thread.start()

    def push(self, state) -> None:
        """Record one stepped state (flat vector) and bump the frame
        counter the page polls on."""
        s = host(state).astype(float)[None]
        frame = (_frames_2d(self._kind, s) if self._mode == "2d"
                 else _frames_3d(self._kind, s))[0]
        with self._lock:
            self._frames.append(frame)
            if len(self._frames) > MAX_FRAMES:
                del self._frames[: len(self._frames) - MAX_FRAMES]
            self._seq += 1

    def finish(self) -> None:
        """Mark the rollout finished (page shows it; server stays up)."""
        with self._lock:
            self._done = True

    def close(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=5)
