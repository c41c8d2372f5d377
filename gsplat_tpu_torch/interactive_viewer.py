"""Interactive web viewer: orbit trained splats in a browser (port of
examples/interactive_viewer.py).

    python -m gsplat_tpu_torch.interactive_viewer --ckpt results/garden/ckpt_30000.npz
    python -m gsplat_tpu_torch.interactive_viewer --demo    # the garden fixture
    # then open http://localhost:8090

A local HTTP server (the standard library's ``http.server``) renders a
frame for each request through `rasterization` and the JAX viewer's
HTML/JS orbit page shows them (drag orbits, shift-drag pans, the wheel
dollies; RGB, depth and alpha modes). A frame goes out as a PNG from the
port's in-memory writer (`datasets.image_io.encode_png`; the JAX viewer
sends a JPEG through PIL, which the card's machine lacks). One lock
serialises the renders of the server's threads. Runs on the card unless
``--cpu`` (or ``main(device="cpu")``) asks for the CPU; without a card it
raises and does not fall back.
"""

from __future__ import annotations

import argparse
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Sequence
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from ._backend import resolve_device
from .checkpoint import splats_from_numpy
from .datasets.image_io import encode_png
from .simple_viewer import SplatRenderer

PAGE = """<!doctype html>
<html><head><title>gsplat_tpu_torch viewer</title><style>
 body { margin:0; background:#111; color:#ddd; font:13px sans-serif;
        overflow:hidden }
 #hud { position:fixed; top:8px; left:8px; background:#000a; padding:8px
        12px; border-radius:6px }
 #img { width:100vw; height:100vh; object-fit:contain; cursor:grab }
 button { margin-right:4px }
 .on { background:#4a7; }
</style></head><body>
<img id="img">
<div id="hud">
 <div>drag: orbit &middot; shift-drag: pan &middot; wheel: dolly</div>
 <div style="margin:6px 0">
  <button id="m_rgb" class="on">RGB</button>
  <button id="m_depth">depth</button>
  <button id="m_alpha">alpha</button>
 </div>
 <div id="stat"></div>
</div>
<script>
 let az=0.8, el=0.4, r=__R0__, tx=0, ty=0, tz=0, mode='rgb';
 let busy=false, dirty=true, t0=0;
 const img=document.getElementById('img'), stat=document.getElementById('stat');
 function url(){ return `/render?az=${az.toFixed(4)}&el=${el.toFixed(4)}`+
   `&r=${r.toFixed(4)}&tx=${tx.toFixed(4)}&ty=${ty.toFixed(4)}`+
   `&tz=${tz.toFixed(4)}&mode=${mode}&_=${Date.now()}`; }
 function tick(){
   if (dirty && !busy){ busy=true; dirty=false; t0=performance.now();
     const u=url();
     fetch(u).then(r=>r.blob()).then(b=>{
       img.src=URL.createObjectURL(b); busy=false;
       stat.textContent=`${(performance.now()-t0).toFixed(0)} ms/frame`;
     }).catch(()=>{busy=false;});
   }
   requestAnimationFrame(tick);
 }
 tick();
 let drag=null;
 img.onpointerdown=e=>{drag=[e.clientX,e.clientY,e.shiftKey];
   img.setPointerCapture(e.pointerId);};
 img.onpointermove=e=>{ if(!drag) return;
   const dx=e.clientX-drag[0], dy=e.clientY-drag[1];
   if (drag[2]){ tx-=dx*r*0.002; ty+=dy*r*0.002; }
   else { az-=dx*0.008; el=Math.max(-1.5,Math.min(1.5,el+dy*0.008)); }
   drag=[e.clientX,e.clientY,drag[2]]; dirty=true; };
 img.onpointerup=()=>{drag=null;};
 window.onwheel=e=>{ r*=Math.exp(e.deltaY*0.001); dirty=true; };
 for (const m of ['rgb','depth','alpha'])
   document.getElementById('m_'+m).onclick=ev=>{
     mode=m; dirty=true;
     for (const x of document.querySelectorAll('button'))
       x.classList.remove('on');
     ev.target.classList.add('on'); };
</script></body></html>"""

MODES = ("rgb", "depth", "alpha")


class Viewer:
    """Orbit-camera frames of checkpoint-layout splats (see
    `simple_viewer.SplatRenderer`) at a fixed size and focal length, on the
    splats' device."""

    def __init__(self, splats, live, sh_degree, width, height, focal):
        self.lock = threading.Lock()
        self.W, self.H = width, height
        self.device = splats["means"].device
        pts = splats["means"] if live is None else splats["means"][live]
        pts = pts.cpu().numpy()
        self.center = np.median(pts, axis=0)
        self.r0 = float(3.0 * np.median(np.abs(pts - self.center)) + 1e-6)
        self.K = torch.tensor([[focal, 0, width / 2], [0, focal, height / 2], [0, 0, 1]], dtype=torch.float32,
                              device=self.device)[None]
        self.render = SplatRenderer(splats, live, sh_degree)

    def look_at(self, az, el, r, pan):
        """The world-to-camera matrix of an eye on a sphere around the
        centre + ``pan`` (z up in the world)."""
        t = self.center + pan
        eye = t + r * np.array([np.cos(el) * np.cos(az), np.cos(el) * np.sin(az), np.sin(el)])
        fwd = t - eye
        fwd /= np.linalg.norm(fwd)
        up = np.array([0.0, 0.0, -1.0])
        right = np.cross(fwd, up)
        nrm = np.linalg.norm(right)
        if nrm < 1e-6:
            right = np.array([1.0, 0.0, 0.0])
        else:
            right /= nrm
        down = np.cross(fwd, right)
        c2w = np.eye(4, dtype=np.float32)
        c2w[:3, 0], c2w[:3, 1] = right, down
        c2w[:3, 2], c2w[:3, 3] = fwd, eye
        return np.linalg.inv(c2w)

    def frame(self, az, el, r, pan, mode):
        """uint8 [H, W, 3]: the colours (``rgb``), the expected depth
        mapped between its 2nd and 98th percentile over pixels of alpha >
        0.2 (``depth``), or the alpha (``alpha``)."""
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
        w2c = torch.as_tensor(self.look_at(az, el, r, pan), dtype=torch.float32, device=self.device)[None]
        with self.lock:
            out, alphas, _ = self.render(w2c, self.K, self.W, self.H, render_mode="RGB+ED")
            out = out[0].cpu().numpy()
            alphas = alphas[0].cpu().numpy()
        if mode == "depth":
            d = out[..., 3]
            m = alphas[..., 0] > 0.2
            lo, hi = np.percentile(d[m], [2, 98]) if m.any() else (0.0, 1.0)
            d = np.clip((d - lo) / max(hi - lo, 1e-6), 0, 1)
            return (np.stack([d, d, 1.0 - d * 0.5], -1) * 255).astype(np.uint8)
        if mode == "alpha":
            return (np.repeat(alphas, 3, axis=-1) * 255).astype(np.uint8)
        return (np.clip(out[..., :3], 0, 1) * 255).astype(np.uint8)


def serve(viewer: Viewer, port: int, host: str = "127.0.0.1") -> ThreadingHTTPServer:
    """A server of the page (``/``), frames (``/render?az&el&r&tx&ty&tz&mode``,
    a PNG) and ``/info``, bound to ``host`` (``port`` 0: any free port).
    The caller runs ``serve_forever`` and ``shutdown``."""

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _send(self, body: bytes, ctype: str, extra=()):
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            for k, v in extra:
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            u = urlparse(self.path)
            if u.path == "/":
                self._send(PAGE.replace("__R0__", f"{viewer.r0:.4f}").encode(), "text/html")
            elif u.path == "/render":
                q = {k: v[0] for k, v in parse_qs(u.query).items()}
                t0 = time.time()
                img = viewer.frame(
                    float(q.get("az", 0)), float(q.get("el", 0)), float(q.get("r", viewer.r0)),
                    np.array([float(q.get("tx", 0)), float(q.get("ty", 0)), float(q.get("tz", 0))]),
                    q.get("mode", "rgb"),
                )
                self._send(encode_png(img), "image/png", [("X-Render-Seconds", f"{time.time() - t0:.3f}")])
            elif u.path == "/info":
                self._send(json.dumps({"width": viewer.W, "height": viewer.H, "r0": viewer.r0}).encode(),
                           "application/json")
            else:
                self.send_response(404)
                self.end_headers()

    httpd = ThreadingHTTPServer((host, port), Handler)
    print(f"viewer listening on http://localhost:{httpd.server_address[1]}", flush=True)
    return httpd


def parse_args(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--demo", action="store_true", help="view the garden fixture splats (no ckpt needed)")
    ap.add_argument("--port", type=int, default=8090)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--focal", type=float, default=520.0)
    ap.add_argument("--sh-degree", type=int, default=3)
    ap.add_argument("--max-points", type=int, default=0, help="subsample the splats (0 = all)")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (the kernels' plain versions)")
    args = ap.parse_args(argv)
    if args.demo and args.ckpt:
        ap.error("--demo and --ckpt are mutually exclusive")
    return args


def build_viewer(args, device) -> Viewer:
    """The `Viewer` of the parsed command line on ``device``."""
    sh_degree = args.sh_degree
    if args.ckpt:
        with np.load(args.ckpt) as blob:
            splats, live = splats_from_numpy({k: blob[k] for k in blob.files}, device=device)
    else:
        from ._helper import load_test_data

        means, quats, scales, opac, colors, *_ = load_test_data()
        n = len(means)
        sel = slice(None)
        if args.max_points and n > args.max_points:
            sel = np.random.default_rng(0).choice(n, args.max_points, replace=False)
        op = np.clip(opac[sel], 1e-6, 1 - 1e-6)
        arrays = {"means": means[sel], "quats": quats[sel], "scales": np.log(np.clip(scales[sel], 1e-7, None)),
                  "opacities": np.log(op / (1 - op))}
        splats = {k: torch.as_tensor(v, dtype=torch.float32, device=device) for k, v in arrays.items()}
        splats["colors"] = torch.as_tensor(colors[sel], dtype=torch.float32, device=device)
        live, sh_degree = None, None
    return Viewer(splats, live, sh_degree, args.width, args.height, args.focal)


def main(argv: Optional[Sequence[str]] = None, device="cuda"):
    """Serve until interrupted. ``--cpu`` or ``device="cpu"`` runs on the
    CPU."""
    args = parse_args(argv)
    device = resolve_device("cpu" if args.cpu else device)
    httpd = serve(build_viewer(args, device), args.port)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()


if __name__ == "__main__":
    main()
