"""The vision inference server: the webcam demo of the JAX package's
``bin/serve.py`` (its default mode), in PyTorch.

The reference's Pluto notebook embeds a webcam widget and classifies the
captured frames with a trained model (``bin/pluto.jl``).  Here a small
stdlib HTTP server does it:

* ``GET /`` — a self-contained page that opens the webcam, draws frames
  to a canvas and POSTs JPEG snapshots to ``/predict``;
* ``POST /predict`` — decode, preprocess as training's eval pipeline
  does (resize the smallest side to 256, center-crop 224, normalise),
  one forward pass in eval mode, and the top-k ``{label, prob}`` as
  JSON; a payload that is not an image answers 400, an unknown path
  404.

:func:`make_app` builds ``predict(jpeg_bytes)`` from a trainer
checkpoint (``--checkpoint``, :mod:`..train.checkpoint`),
torchvision-layout weights (``--torch-weights``: a plain
``load_state_dict``, since the port's models use torchvision's names)
or random weights (seed 0).  ``predict.from_array(img)`` is its
decode-free twin on a uint8 ``[H, W, 3]`` array (the body after
decoding).  :func:`serve` puts ``predict`` behind the server.
"""

from __future__ import annotations

import json
import time
from typing import Callable, List, Optional

import numpy as np
import torch

__all__ = ["HTML", "class_names", "load_image_model", "make_app", "serve"]

HTML = """<!doctype html>
<html><head><title>fluxdistributed_tpu_torch live inference</title><style>
 body{font-family:sans-serif;max-width:720px;margin:2em auto}
 video,canvas{width:320px;height:240px;background:#222;border-radius:8px}
 table{border-collapse:collapse;margin-top:1em}
 td,th{padding:4px 12px;border-bottom:1px solid #ccc;text-align:left}
</style></head><body>
<h2>Live inference</h2>
<p>Frames are captured from your camera and classified server-side.</p>
<video id="v" autoplay playsinline muted></video>
<canvas id="c" width="320" height="240" style="display:none"></canvas>
<p><button id="go">start</button> <span id="status"></span></p>
<table id="preds"><thead><tr><th>#</th><th>class</th><th>p</th></tr></thead>
<tbody></tbody></table>
<script>
const v=document.getElementById('v'),c=document.getElementById('c'),
      ctx=c.getContext('2d'),tb=document.querySelector('#preds tbody'),
      st=document.getElementById('status');
let running=false;
async function tick(){
  if(!running) return;
  ctx.drawImage(v,0,0,c.width,c.height);
  const blob=await new Promise(r=>c.toBlob(r,'image/jpeg',0.8));
  try{
    const resp=await fetch('/predict',{method:'POST',body:blob});
    const data=await resp.json();
    tb.innerHTML=data.predictions.map((p,i)=>
      `<tr><td>${i+1}</td><td>${p.label}</td><td>${p.prob.toFixed(3)}</td></tr>`).join('');
    st.textContent=`${data.ms.toFixed(0)} ms/frame`;
  }catch(e){st.textContent=e; running=false;}
  setTimeout(tick,250);
}
document.getElementById('go').onclick=async()=>{
  if(running){running=false;return;}
  const s=await navigator.mediaDevices.getUserMedia({video:true});
  v.srcObject=s; running=true; tick();
};
</script></body></html>"""


def load_image_model(name: str, num_classes: int, *,
                     checkpoint: Optional[str] = None,
                     step: Optional[int] = None,
                     torch_weights: Optional[str] = None,
                     device=None):
    """``(model, source)``: the image model ``name`` on ``device`` in
    eval form, its weights from a trainer ``checkpoint`` directory (the
    latest step, or ``step``; its params and running stats, whatever
    optimizer saved it), from a torchvision-layout ``torch_weights``
    file, or random (seed 0); ``source`` says which.  Remote locations
    (``http(s)://``, ``gs://``) go through the dataset source cache.
    Raises ``ValueError`` on an unknown model or both weight sources."""
    from .. import models
    from ..data.sources import fetch_artifact, fetch_checkpoint

    factory = getattr(models, name, None)
    if factory is None or name.startswith("lm_"):
        raise ValueError(f"unknown image model {name!r}")
    if torch_weights and checkpoint:
        raise ValueError("--torch-weights and --checkpoint are mutually "
                         "exclusive")
    kw = {}
    if torch_weights and name.startswith("vit_"):
        # torchvision's ViT: class-token readout, exact GELU
        kw = {"use_class_token": True, "gelu_exact": True}
    elif torch_weights and name.startswith("convnext_"):
        kw = {"gelu_exact": True}
    model = factory(num_classes=num_classes, device=device, seed=0, **kw)
    if torch_weights:
        sd = torch.load(fetch_artifact(torch_weights), map_location="cpu",
                        weights_only=True)
        if isinstance(sd, dict) and "state_dict" in sd:
            sd = sd["state_dict"]
        model.load_state_dict(sd)
        source = f"torch-layout weights from {torch_weights}"
    elif checkpoint:
        from ..train.checkpoint import load_checkpoint

        restored = load_checkpoint(fetch_checkpoint(checkpoint), step=step)
        model.load_state_dict({**restored["params"],
                               **restored.get("model_state", {})})
        source = (f"checkpoint step {int(restored['step'])} from "
                  f"{checkpoint}")
    else:
        source = "random init (seed 0)"
    return model.eval(), source


def class_names(synset: Optional[str]) -> Optional[List[str]]:
    """The first name of each class of a ``LOC_synset_mapping.txt``
    (local or fetched), or ``None``."""
    if not synset:
        return None
    from ..data.imagenet import labels
    from ..data.sources import fetch_artifact

    return [n.split(",")[0] for n in labels(fetch_artifact(synset)).names]


def make_app(args) -> Callable[[bytes], list]:
    """``predict(jpeg_bytes) -> [{"label", "prob"}, ...]`` (the top
    ``args.topk``), with ``predict.from_array(img)`` on a decoded uint8
    ``[H, W, 3]`` array; apart from :func:`serve` so that tests drive it
    directly.  ``args`` carries ``model``, ``num_classes``,
    ``checkpoint``, ``step``, ``torch_weights``, ``synset``, ``topk``
    and ``device``."""
    from ..data.preprocess import decode_image, preprocess
    from ..device import resolve_device

    device = resolve_device(getattr(args, "device", None))
    try:
        model, _src = load_image_model(
            args.model, args.num_classes, checkpoint=args.checkpoint,
            step=getattr(args, "step", None),
            torch_weights=args.torch_weights, device=device)
    except ValueError as e:
        raise SystemExit(str(e))
    names = class_names(args.synset)

    def from_array(img: np.ndarray) -> list:
        x = torch.from_numpy(preprocess(np.asarray(img, np.uint8))[None])
        with torch.no_grad():
            logits = model(x.to(device)).float()[0]
        p = torch.softmax(logits, dim=-1).cpu().numpy()
        top = np.argsort(-p, kind="stable")[:args.topk]
        return [{"label": names[i] if names else f"class {i}",
                 "prob": float(p[i])} for i in top]

    def predict(jpeg_bytes: bytes) -> list:
        return from_array(decode_image(jpeg_bytes))

    # one forward before the first request (kernels load, cuDNN picks)
    from_array(np.zeros((256, 256, 3), np.uint8))
    predict.from_array = from_array
    return predict


def serve(args, predict):
    """A ``ThreadingHTTPServer`` on ``args.host:args.port`` (0: an
    ephemeral port) serving the page and ``predict``; the caller runs
    ``serve_forever``."""
    import http.server

    class Handler(http.server.BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _send(self, code, body: bytes, ctype: str):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path in ("/", "/index.html"):
                self._send(200, HTML.encode(), "text/html")
            else:
                self._send(404, b"not found", "text/plain")

        def do_POST(self):
            if self.path != "/predict":
                self._send(404, b"not found", "text/plain")
                return
            n = int(self.headers.get("Content-Length", 0))
            data = self.rfile.read(n)
            t0 = time.perf_counter()
            try:
                preds = predict(data)
            except Exception as e:  # noqa: BLE001 — a bad frame: report it
                self._send(400, json.dumps({"error": str(e)}).encode(),
                           "application/json")
                return
            body = json.dumps({"predictions": preds,
                               "ms": (time.perf_counter() - t0) * 1e3})
            self._send(200, body.encode(), "application/json")

    return http.server.ThreadingHTTPServer((args.host, args.port), Handler)
