"""Two-replica A/B web demo: dense against FrameFusion side by side, with
STREAMED partial generations, on one H100.

The reference's demo is a Gradio app with two GPU replicas, threaded
generation with streamed partial results and latency bars. Here it is a
stdlib HTTP server: the page opens an EventSource on GET /stream, the server
generates with both replicas at once (a ``ThreadPoolExecutor``, each replica
on a CUDA stream of its own) and pushes one SSE event a decode chunk a
replica (``engine.generate_stream``: the tokens so far), then a final event
with the latencies and the compression telemetry.

Each replica's decode is a captured CUDA graph. Captures are made before the
two threads start (``DemoState.warm``, once a decode geometry, one replica
after the other), so no capture runs beside the other replica's work; the
warm-up's solo decodes are what each stream must end with.

Usage: python -m framefusion_tpu_torch.scripts.demo_compare [--port 7860], then
open the page; or --selftest for the reference's start-up check, which also
asserts that each replica streamed >= 2 growing updates ending with its solo
tokens. --device cpu runs it on the CPU.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, HTTPServer

import numpy as np
import torch

from .common import DeviceTimer, add_device_arg, generator, resolve_device, synthetic_video, tiny_config

PAGE = """<!doctype html><html><head><title>FrameFusion A/B</title><style>
body{font-family:sans-serif;max-width:900px;margin:2em auto}
.col{display:inline-block;width:45%;vertical-align:top;padding:1em;border:1px solid #ccc;border-radius:8px;margin:0.5em}
.bar{height:18px;background:#4a90d9;border-radius:3px}
pre{white-space:pre-wrap}</style></head><body>
<h2>FrameFusion: dense vs compressed</h2>
<button onclick="run()">Run A/B generation</button> <span id="status"></span>
<div><div class="col"><h3>Dense</h3><div id="bar_a" class="bar" style="width:0"></div>
<p id="lat_a"></p><pre id="out_a"></pre></div>
<div class="col"><h3>FrameFusion</h3><div id="bar_b" class="bar" style="width:0"></div>
<p id="lat_b"></p><pre id="out_b"></pre></div></div>
<h3>Compression telemetry</h3><pre id="tel"></pre>
<script>
function run(){
  document.getElementById('status').textContent=' running...';
  const es = new EventSource('/stream');
  es.onmessage = (m)=>{
    const d = JSON.parse(m.data);
    if (d.kind === 'partial'){
      const id = d.replica === 'dense' ? 'out_a' : 'out_b';
      document.getElementById(id).textContent = 'tokens: '+d.tokens.join(' ');
    } else if (d.kind === 'final'){
      const mx = Math.max(d.dense_ms, d.ff_ms);
      document.getElementById('bar_a').style.width = (90*d.dense_ms/mx)+'%';
      document.getElementById('bar_b').style.width = (90*d.ff_ms/mx)+'%';
      document.getElementById('lat_a').textContent = d.dense_ms.toFixed(1)+' ms prefill';
      document.getElementById('lat_b').textContent = d.ff_ms.toFixed(1)+' ms prefill ('+d.speedup.toFixed(2)+'x)';
      document.getElementById('tel').textContent = JSON.stringify(d.telemetry, null, 2);
      document.getElementById('status').textContent=' done';
      es.close();
    }
  };
  es.onerror = ()=>{ es.close(); document.getElementById('status').textContent=' error'; };
}
</script></body></html>"""


class DemoState:
    """The two replicas (dense and FrameFusion, each with its own engine)
    over one small random model, and the demo's prompt."""

    def __init__(self, num_frames: int = 16, device: torch.device = torch.device("cuda")):
        from ..interface import FrameFusionModel, apply_framefusion
        from ..models import qwen2
        from ..models.adapters import llava_video
        from ..models.vision import siglip
        from ..models.vision.llava_frontend import encode_video, init_projector
    
        cfg = tiny_config(device, num_layers=8, hidden_size=256, intermediate_size=512, num_heads=8)
        params = qwen2.init_params(cfg, generator(device, 0))
        vit_cfg = siglip.tiny_vit_config(image_size=56, patch_size=7, dtype=cfg.dtype)
        vit = siglip.init_params(vit_cfg, generator(device, 1))
        proj = init_projector(generator(device, 2), vit_cfg.hidden_size, cfg.hidden_size, cfg.dtype)

        rng = np.random.default_rng(0)
        frames = synthetic_video(rng, num_frames, vit_cfg.image_size)
        toks = encode_video(vit, vit_cfg, proj, frames).to(torch.float32) * 0.05
        text = torch.from_numpy((rng.standard_normal((24, cfg.hidden_size)) * 0.05).astype(np.float32)).to(device)
        self.inputs = llava_video.build_prefill_inputs(text, toks, 20, vit_cfg.patches_per_side)
        self.inputs.input_embeds = self.inputs.input_embeds.to(cfg.dtype)

        # Replica A dense, replica B FrameFusion: two engines (the
        # reference puts them on two cards; here they share one).
        self.dense = FrameFusionModel(family="llava_video", cfg=cfg, params=params)
        ff = apply_framefusion(self.dense, 0.3, 0.6, 0.1)
        ff.ff = ff.ff.replace(schedule_num_layers=cfg.num_layers)
        self.ff = ff
        self.device = device
        self.streams = ({name: torch.cuda.Stream(device=device) for name in ("dense", "ff")}
                        if device.type == "cuda" else {})
        self.solo: dict = {}  # max_new_tokens -> {replica: its solo greedy tokens}
        self.lock = threading.Lock()

    def replicas(self) -> dict:
        return {"dense": self.dense, "ff": self.ff}

    def warm(self, max_new_tokens: int) -> dict:
        """Each replica's prefill and solo greedy decode of ``max_new_tokens``,
        one after the other, once a length: this captures the decode graph
        each replica's stream will replay, before any two run at once.
        Returns the solo tokens by replica."""
        if max_new_tokens not in self.solo:
            self.solo[max_new_tokens] = {
                name: m.engine().generate(m.prefill(self.inputs), max_new_tokens)
                for name, m in self.replicas().items()}
        return self.solo[max_new_tokens]

    def run_ab_stream(self, emit, max_new_tokens: int = 12, chunk: int = 3) -> dict:
        """Generate with both replicas at once, pushing one ``emit(event)``
        a decode chunk a replica (kind "partial", the tokens so far) and a
        closing kind "final" event with the latencies and the telemetry."""

        def gen(name, model):
            stream = self.streams.get(name)
            with torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext():
                t, res = DeviceTimer.timeit(lambda: model.prefill(self.inputs), lambda r: r.logits, reps=1)
                toks = []
                for toks in model.engine().generate_stream(res, max_new_tokens, chunk=chunk):
                    emit({"kind": "partial", "replica": name, "tokens": toks})
            return t * 1e3, toks, res

        with self.lock:
            self.warm(max_new_tokens)
            with ThreadPoolExecutor(max_workers=2) as ex:
                fa = ex.submit(gen, "dense", self.dense)
                fb = ex.submit(gen, "ff", self.ff)
                dense_ms, dense_toks, _ = fa.result()
                ff_ms, ff_toks, ff_res = fb.result()
        final = {
            "kind": "final",
            "dense_ms": dense_ms, "ff_ms": ff_ms, "speedup": dense_ms / ff_ms,
            "dense_tokens": dense_toks, "ff_tokens": ff_toks,
            "telemetry": ff_res.telemetry.summary(),
        }
        emit(final)
        return final


def selftest(state: DemoState) -> dict:
    """The reference's start-up check plus the streaming contract: both
    replicas push >= 2 growing partial updates before the final event, and
    each stream ends with that replica's solo greedy tokens."""
    events = []
    lock = threading.Lock()

    def emit(e):
        with lock:
            events.append(e)

    out = state.run_ab_stream(emit, max_new_tokens=9, chunk=3)
    partials = {"dense": [], "ff": []}
    for e in events[:-1]:
        assert e["kind"] == "partial", e
        partials[e["replica"]].append(e["tokens"])
    assert events[-1]["kind"] == "final"
    solo = state.warm(9)
    for name, seen in partials.items():
        assert len(seen) >= 2, f"{name} streamed {len(seen)} updates (<2)"
        for a, b in zip(seen, seen[1:]):
            assert b[:len(a)] == a, f"{name} partials not cumulative"
        assert seen[-1] == out[f"{name}_tokens"]
        assert seen[-1] == solo[name], f"{name} streamed {seen[-1]}, its solo decode gave {solo[name]}"
    print(json.dumps({k: v for k, v in out.items() if k != "telemetry"}, allow_nan=False))
    print("sanity ok: speedup", round(out["speedup"], 2),
          "| stream updates:", {k: len(v) for k, v in partials.items()})
    return {"final": out, "partials": partials}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--port", type=int, default=7860)
    p.add_argument("--num-frames", type=int, default=16)
    p.add_argument("--selftest", action="store_true")
    add_device_arg(p)
    args = p.parse_args(argv)
    state = DemoState(args.num_frames, resolve_device(args.device))
    if args.selftest:
        return selftest(state)

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):
            if self.path != "/stream":
                self.send_response(200)
                self.send_header("Content-Type", "text/html")
                self.end_headers()
                self.wfile.write(PAGE.encode())
                return
            # SSE: one event a decode chunk a replica, then the final one.
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.end_headers()
            q: "queue.Queue" = queue.Queue()
            worker = threading.Thread(target=lambda: (state.run_ab_stream(q.put), q.put(None)), daemon=True)
            worker.start()
            while True:
                ev = q.get()
                if ev is None:
                    break
                try:
                    self.wfile.write(f"data: {json.dumps(ev)}\n\n".encode())
                    self.wfile.flush()
                except BrokenPipeError:
                    break  # the client went away; the worker drains on its own

        def log_message(self, *a):
            pass

    print(f"serving on http://localhost:{args.port}")
    HTTPServer(("0.0.0.0", args.port), Handler).serve_forever()


if __name__ == "__main__":
    main()
