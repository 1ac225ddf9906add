"""`rs serve` — on-demand tile server running segmentation per request.

Counterpart of robosat_tpu/tools/serve.py, with its flags, its viewer
(`MAP_TEMPLATE`, the same string) and its answers: `GET /<z>/<x>/<y>.png`
fetches the upstream imagery tile, runs the segment step
(`parallel/steps.make_segment_step`: the float32 folded forward over
batch norm folded once at start, and an argmax) on the device the model
config's `cuda` key names, and answers
with a palette mask PNG; `GET /` and `/index.html` serve the before/after
swipe viewer; other zooms than 18 and unknown paths answer 404, a tile the
upstream does not give 500; every answer carries the CORS header. The
stdlib HTTP server is single-threaded, as the reference's
app.run(threaded=False). `requests` is imported by `main`, so that the
command line loads without it. Contract parity: robosat/tools/serve.py.
"""

import argparse
import io
import os
import sys
from http.server import BaseHTTPRequestHandler, HTTPServer

import numpy as np
from PIL import Image

from robosat_tpu_torch.checkpoint import load_model_checkpoint
from robosat_tpu_torch.colors import make_palette
from robosat_tpu_torch.config import load_config
from robosat_tpu_torch.device import configure_device
from robosat_tpu_torch.models.registry import get_model
from robosat_tpu_torch.parallel.steps import make_segment_step
from robosat_tpu_torch.tiles import fetch_image

# Before/after swipe-compare viewer (capability parity with the reference's
# Mapbox GL compare template, robosat/tools/templates/map.html:37-80),
# implemented from scratch on Leaflet: two view-synced maps, the "after" map
# carrying the segmentation overlay and clipped at a draggable divider.
MAP_TEMPLATE = """<!DOCTYPE html>
<html>
<head>
  <meta charset="utf-8"/>
  <title>robosat-tpu</title>
  <meta name="viewport" content="width=device-width, initial-scale=1.0"/>
  <link rel="stylesheet" href="https://unpkg.com/leaflet@1.9.4/dist/leaflet.css"/>
  <script src="https://unpkg.com/leaflet@1.9.4/dist/leaflet.js"></script>
  <style>
    html, body {{ height: 100%; margin: 0; overflow: hidden; }}
    .pane {{ position: absolute; inset: 0; }}
    #after {{ z-index: 400; }}
    #swipe {{ position: absolute; top: 0; bottom: 0; width: 4px; z-index: 1000;
             background: #fff; cursor: ew-resize; box-shadow: 0 0 4px rgba(0,0,0,.5); }}
    #swipe::after {{ content: "\\2194"; position: absolute; top: 50%; left: 50%;
                    transform: translate(-50%, -50%); background: #fff;
                    border-radius: 50%; width: 28px; height: 28px;
                    text-align: center; line-height: 28px; }}
    #opacity {{ position: absolute; top: 10px; right: 10px; z-index: 1100;
               background: white; padding: 6px 10px; border-radius: 4px;
               font: 13px sans-serif; }}
  </style>
</head>
<body>
  <div id="before" class="pane"></div>
  <div id="after" class="pane"></div>
  <div id="swipe"></div>
  <div id="opacity">
    mask <input id="slider" type="range" min="0" max="100" value="60"/>
  </div>
  <script>
    var imagery = 'https://api.mapbox.com/styles/v1/mapbox/satellite-v9/tiles/256/{{z}}/{{x}}/{{y}}?access_token={token}';
    var opts = {{ maxZoom: 18, tileSize: {size}, zoomOffset: 0 }};

    var before = L.map('before', {{ zoomControl: true }}).setView([49.0047, 8.3858], 18);
    var after = L.map('after', {{ zoomControl: false, attributionControl: false }});
    L.tileLayer(imagery, opts).addTo(before);
    L.tileLayer(imagery, opts).addTo(after);
    var mask = L.tileLayer('http://127.0.0.1:{port}/{{z}}/{{x}}/{{y}}.png',
      {{ maxZoom: 18, opacity: 0.6, tileSize: {size} }}).addTo(after);

    // Keep the two views locked together (either map can be dragged).
    var syncing = false;
    function follow(src, dst) {{
      src.on('move zoom', function () {{
        if (syncing) return;
        syncing = true;
        dst.setView(src.getCenter(), src.getZoom(), {{ animate: false }});
        syncing = false;
      }});
    }}
    after.setView(before.getCenter(), before.getZoom());
    follow(before, after);
    follow(after, before);

    // The swipe divider clips the after-map to its right side.
    var divider = document.getElementById('swipe');
    function setSwipe(x) {{
      var w = document.body.clientWidth;
      x = Math.max(0, Math.min(x, w - 4));
      divider.style.left = x + 'px';
      document.getElementById('after').style.clipPath =
        'inset(0 0 0 ' + (x + 2) + 'px)';
    }}
    setSwipe(document.body.clientWidth / 2);
    var dragging = false;
    divider.addEventListener('pointerdown', function (e) {{
      dragging = true; divider.setPointerCapture(e.pointerId);
    }});
    window.addEventListener('pointermove', function (e) {{
      if (dragging) setSwipe(e.clientX);
    }});
    window.addEventListener('pointerup', function () {{ dragging = false; }});
    window.addEventListener('resize', function () {{
      setSwipe(document.body.clientWidth / 2);
    }});

    document.getElementById('slider').oninput = function () {{
      mask.setOpacity(this.value / 100.0);
    }};
  </script>
</body>
</html>
"""


def add_parser(subparser):
    parser = subparser.add_parser(
        "serve",
        help="tile server running segmentation per request",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )

    parser.add_argument("--model", type=str, required=True, help="path to model configuration file")
    parser.add_argument("--dataset", type=str, required=True, help="path to dataset configuration file")
    parser.add_argument("--url", type=str, help="endpoint with {z}/{x}/{y} variables to fetch image tiles from")
    parser.add_argument("--checkpoint", type=str, required=True, help="checkpoint to serve")
    parser.add_argument("--tile_size", type=int, default=512, help="side length of served tiles in pixels")
    parser.add_argument("--host", type=str, default="127.0.0.1", help="bind address")
    parser.add_argument("--port", type=int, default=5000, help="bind port")

    parser.set_defaults(func=main)


class Predictor:
    """Single-tile segmentation: image -> palette mask PNG bytes, on the
    device of the model config's `cuda` key (the card for true, the CPU for
    false)."""

    def __init__(self, checkpoint, model_config, dataset_config, tile_size):
        device = configure_device(model_config["common"]["cuda"])
        num_classes = len(dataset_config["common"]["classes"])
        model = get_model(model_config["common"].get("model", "unet"))
        self.params, self.state, _ = load_model_checkpoint(checkpoint, num_classes, device=device)
        self.step = make_segment_step(model)
        # Batch norm folded once here, not on every request (SegFormer has no fold).
        self.folded = model.fold(self.params, self.state) if hasattr(self.step, "folded") else None
        self.palette = make_palette(*dataset_config["common"]["colors"])
        self.tile_size = tile_size

    def mask(self, raw):
        """uint8 (N, H, W, 3) -> class indices uint8 (N, H, W) on the device."""
        if self.folded is None:
            return self.step(self.params, self.state, raw)
        return self.step.folded(self.folded, raw)

    def segment(self, image):
        raw = np.array(image.convert("RGB"))[None]
        mask = self.mask(raw).cpu().numpy()[0]

        out = Image.fromarray(mask.astype(np.uint8), mode="P")
        out.putpalette(self.palette)

        buf = io.BytesIO()
        out.save(buf, format="png", optimize=False, compress_level=1)  # serving latency > size
        return buf.getvalue()


def make_handler(predictor, session, upstream, token, tile_size, port):
    index_html = MAP_TEMPLATE.format(token=token, size=tile_size, port=port).encode()

    class TileHandler(BaseHTTPRequestHandler):
        def _send(self, code, body=b"", content_type="text/plain"):
            self.send_response(code)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            self.send_header("Access-Control-Allow-Origin", "*")
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, fmt, *fmt_args):  # quiet request logging
            pass

        def do_GET(self):
            if self.path in ("/", "/index.html"):
                self._send(200, index_html, "text/html")
                return

            parts = self.path.lstrip("/").split("/")
            if len(parts) == 3 and parts[2].endswith(".png"):
                try:
                    z, x = int(parts[0]), int(parts[1])
                    y = int(parts[2][: -len(".png")])
                except ValueError:
                    self._send(404)
                    return

                # Post-processing is tuned for z18 (robosat/tools/serve.py:54).
                if z != 18:
                    self._send(404)
                    return

                url = upstream.format(x=x, y=y, z=z)
                res = fetch_image(session, url)
                if not res:
                    self._send(500)
                    return

                png = predictor.segment(Image.open(res))
                self._send(200, png, "image/png")
                return

            self._send(404)

    return TileHandler


def main(args):
    model_config = load_config(args.model)
    dataset_config = load_config(args.dataset)

    token = os.getenv("MAPBOX_ACCESS_TOKEN")
    if not token:
        sys.exit("Error: map token needed visualizing results; export MAPBOX_ACCESS_TOKEN")

    import requests

    session = requests.Session()
    predictor = Predictor(args.checkpoint, model_config, dataset_config, args.tile_size)

    handler = make_handler(predictor, session, args.url, token, args.tile_size, args.port)
    server = HTTPServer((args.host, args.port), handler)
    print("Serving on http://{}:{}".format(args.host, args.port))
    server.serve_forever()
