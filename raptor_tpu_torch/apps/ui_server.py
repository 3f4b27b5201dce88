"""Standalone ui-server: websocket relay + embedded browser viewer.

A copy of `raptor_tpu/apps/ui_server.py` (standard-library asyncio over
`websockets`, no JAX), the counterpart of the reference's `ui-server` pip
package: run it, open http://localhost:13337, and point simulators at
ws://localhost:13337/backend.

Protocol (the client is `raptor_tpu_torch/env/ui.py`'s `UIClient`):

- A SIMULATOR connects to ``ws://host:port/backend`` and immediately
  receives ``{"channel": "handshake", "data": {"namespace": "<ns>"}}``.
  It then streams ``ui_message`` / ``parameters_message`` /
  ``state_action_message`` JSON frames.
- A BROWSER loads ``http://host:port/`` (an embedded, dependency-free canvas
  viewer that needs no network) which opens ``ws://host:port/ui``. Every
  backend frame is relayed to every viewer; late-joining viewers are
  replayed each namespace's last ``ui_message`` and ``parameters_message``
  so they can set up the scene mid-run.
- When a backend disconnects the server broadcasts
  ``{"channel": "namespace_closed", "data": {"namespace": ns}}``.

Run: ``python -m raptor_tpu_torch.apps.ui_server [--port 13337]``, then e.g.
``python -m raptor_tpu_torch.apps.visualize CHECKPOINT --n-envs 4``.
`websockets` is imported when the server starts.
"""

from __future__ import annotations

import argparse
import asyncio
import http
import json
from typing import Dict, Optional, Set


class UIServer:
    """Relay hub: backends stream frames in, viewers fan out."""

    def __init__(self):
        self._viewers: Set = set()
        self._ns_counter = 0
        # per-namespace scene-setup frames replayed to late-joining viewers
        self._scene: Dict[str, Dict[str, str]] = {}
        self.port: Optional[int] = None
        self._server = None

    # ------------------------------------------------------------ relay
    def _next_namespace(self) -> str:
        self._ns_counter += 1
        return str(self._ns_counter - 1)

    async def _broadcast(self, raw: str):
        dead = []
        for v in self._viewers:
            try:
                await v.send(raw)
            except Exception:
                dead.append(v)
        for v in dead:
            self._viewers.discard(v)

    async def _handle_backend(self, ws, requested_ns: Optional[str]):
        ns = requested_ns or self._next_namespace()
        await ws.send(
            json.dumps({"channel": "handshake", "data": {"namespace": ns}})
        )
        self._scene[ns] = {}
        try:
            async for raw in ws:
                try:
                    msg = json.loads(raw)
                except json.JSONDecodeError:
                    continue  # drop malformed frames, keep the stream alive
                data = msg.setdefault("data", {})
                if isinstance(data, dict):
                    data.setdefault("namespace", ns)
                raw = json.dumps(msg)
                ch = msg.get("channel")
                if ch in ("ui_message", "parameters_message"):
                    self._scene[ns][ch] = raw
                await self._broadcast(raw)
        finally:
            self._scene.pop(ns, None)
            await self._broadcast(
                json.dumps(
                    {"channel": "namespace_closed", "data": {"namespace": ns}}
                )
            )

    async def _handle_viewer(self, ws):
        self._viewers.add(ws)
        try:
            # replay scene setup for every live namespace (stable order)
            for ns in sorted(self._scene):
                for ch in ("ui_message", "parameters_message"):
                    raw = self._scene[ns].get(ch)
                    if raw is not None:
                        await ws.send(raw)
            async for _ in ws:
                pass  # viewers are receive-only; ignore anything they send
        finally:
            self._viewers.discard(ws)

    async def _handler(self, ws):
        path = ws.request.path.split("?", 1)[0].rstrip("/")
        if path == "/backend" or path.startswith("/backend/"):
            requested = path[len("/backend/"):] or None
            await self._handle_backend(ws, requested)
        else:  # "/ui" and anything else that upgraded to websocket
            await self._handle_viewer(ws)

    # ------------------------------------------------------- http viewer
    def _process_request(self, connection, request):
        """Serve the embedded viewer page on plain-HTTP GET /."""
        if "Upgrade" in request.headers:
            return None  # continue the websocket handshake
        path = request.path.split("?", 1)[0]
        if path in ("/", "/index.html"):
            resp = connection.respond(http.HTTPStatus.OK, VIEWER_HTML)
            resp.headers["Content-Type"] = "text/html; charset=utf-8"
            return resp
        return connection.respond(http.HTTPStatus.NOT_FOUND, "not found\n")

    # ---------------------------------------------------------- lifecycle
    async def start(self, host: str = "0.0.0.0", port: int = 13337):
        import websockets

        self._server = await websockets.serve(
            self._handler, host, port, process_request=self._process_request
        )
        self.port = self._server.sockets[0].getsockname()[1]
        return self

    async def stop(self):
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()


# ---------------------------------------------------------------------------
# Embedded viewer: self-contained canvas renderer (no egress for CDN libs).
# Orthographic-ish perspective projection, FLU axes mapped to screen, one
# cross of rotor discs per quadrotor, per-rotor throttle coloring, position
# trails. Enough to watch a swarm fly; the reference uses a three.js GLB
# scene, which needs networked assets.
# ---------------------------------------------------------------------------
VIEWER_HTML = """<!doctype html>
<html><head><meta charset="utf-8"><title>raptor-tpu ui-server</title>
<style>
 body{margin:0;background:#10131a;color:#d7dce5;font:13px system-ui}
 #hud{position:fixed;top:8px;left:10px;white-space:pre}
 canvas{display:block}
</style></head><body>
<div id="hud">raptor-tpu ui-server — waiting for backend…</div>
<canvas id="c"></canvas>
<script>
const cv=document.getElementById('c'),cx=cv.getContext('2d'),hud=document.getElementById('hud');
function fit(){cv.width=innerWidth;cv.height=innerHeight}addEventListener('resize',fit);fit();
const scenes={}; let frames=0;
// FLU world -> screen: x forward (right on screen), y left, z up. Simple
// fixed camera: screen_x = x - 0.5*y, screen_y = -(z - 0.25*y), scaled.
function proj(p,S,cxp,cyp){return [cxp+S*(p[0]-0.5*p[1]), cyp-S*(p[2]-0.25*p[1])]}
function qrot(q,v){ // rotate v by quaternion [w,x,y,z]
 const[w,x,y,z]=q,[vx,vy,vz]=v;
 const tx=2*(y*vz-z*vy),ty=2*(z*vx-x*vz),tz=2*(x*vy-y*vx);
 return[vx+w*tx+y*tz-z*ty, vy+w*ty+z*tx-x*tz, vz+w*tz+x*ty-y*tx];
}
function draw(){
 cx.fillStyle='#10131a';cx.fillRect(0,0,cv.width,cv.height);
 const S=Math.min(cv.width,cv.height)/8, cxp=cv.width/2, cyp=cv.height/2;
 // ground grid (z=0 plane)
 cx.strokeStyle='#222a38';cx.beginPath();
 for(let g=-3;g<=3;g++){
  let a=proj([g,-3,0],S,cxp,cyp),b=proj([g,3,0],S,cxp,cyp);
  cx.moveTo(a[0],a[1]);cx.lineTo(b[0],b[1]);
  a=proj([-3,g,0],S,cxp,cyp);b=proj([3,g,0],S,cxp,cyp);
  cx.moveTo(a[0],a[1]);cx.lineTo(b[0],b[1]);
 }cx.stroke();
 let n=0;
 for(const ns in scenes){const sc=scenes[ns];if(!sc.states)continue;
  sc.states.forEach((st,i)=>{n++;
   const rp=(sc.rotors&&sc.rotors[i])||[[0.06,-0.06,0],[-0.06,-0.06,0],[-0.06,0.06,0],[0.06,0.06,0]];
   const act=(sc.actions&&sc.actions[i])||[0,0,0,0];
   // trail
   (sc.trails[i]=sc.trails[i]||[]).push(st.position.slice());
   if(sc.trails[i].length>300)sc.trails[i].shift();
   cx.strokeStyle='rgba(110,168,254,0.35)';cx.beginPath();
   sc.trails[i].forEach((p,k)=>{const q=proj(p,S,cxp,cyp);k?cx.lineTo(q[0],q[1]):cx.moveTo(q[0],q[1])});
   cx.stroke();
   // arms + rotors
   const ctr=proj(st.position,S,cxp,cyp);
   rp.forEach((r,j)=>{
    const w=qrot(st.orientation,r).map((v,k)=>v*3+st.position[k]); // 3x arm exaggeration
    const pw=proj(w,S,cxp,cyp);
    cx.strokeStyle='#8a93a6';cx.beginPath();cx.moveTo(ctr[0],ctr[1]);cx.lineTo(pw[0],pw[1]);cx.stroke();
    const t=Math.max(0,Math.min(1,(act[j]+1)/2));
    cx.fillStyle=`rgb(${40+215*t},${180-80*t},${90})`;
    cx.beginPath();cx.arc(pw[0],pw[1],3+3*t,0,7);cx.fill();
   });
   cx.fillStyle='#e8ecf4';cx.beginPath();cx.arc(ctr[0],ctr[1],3,0,7);cx.fill();
  });
 }
 hud.textContent=`raptor-tpu ui-server  namespaces:${Object.keys(scenes).length}  drones:${n}  frames:${frames}`;
 requestAnimationFrame(draw);
}
const ws=new WebSocket(`ws://${location.host}/ui`);
ws.onmessage=ev=>{const m=JSON.parse(ev.data),d=m.data||{},ns=d.namespace;
 if(m.channel==='namespace_closed'){delete scenes[ns];return}
 const sc=scenes[ns]=scenes[ns]||{trails:[]};
 if(m.channel==='parameters_message'&&d.parameters)
  sc.rotors=d.parameters.map(p=>(p.dynamics&&p.dynamics.rotor_positions)||null);
 if(m.channel==='state_action_message'){sc.states=d.states;sc.actions=d.actions;frames++}
};
draw();
</script></body></html>
"""


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="raptor-tpu ui-server (websocket relay + browser viewer)"
    )
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=13337)
    args = ap.parse_args(argv)

    async def run():
        srv = await UIServer().start(args.host, args.port)
        print(
            f"ui-server on http://{args.host}:{srv.port} "
            f"(backends: ws://{args.host}:{srv.port}/backend)"
        )
        await asyncio.Future()  # serve forever

    try:
        asyncio.run(run())
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
