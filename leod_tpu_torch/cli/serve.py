"""Stateful streaming detection server (port of `cli/serve.py`).

Loads a `cli/export.py` artifact (or builds the step live from a
checkpoint), wraps it in the micro-batching `ServingEngine`
(`serve.py`), and exposes the JAX server's stdlib HTTP API:

    GET  /v1/health
        -> {"status": "ok", "steps": N, "streams": n, "slots": B, ...}
    POST /v1/detect   {"stream": "<id>", "frame_b64": "<base64 bytes>"}
        -> {"boxes": [[x0, y0, x1, y1, obj_conf, cls_conf, cls_id], ...],
            "classes": [...]}

`frame_b64` is the raw bytes of one uint8 frame of the artifact's
"frame_shape" (`<artifact>.json`: raw [H, W, C] with --raw-layout,
otherwise the prefolded [H/4, W/4, 16C]). Streams keep their LSTM state
across requests; a stream id unseen since its slot was evicted starts
fresh. Runs on the card unless `--cpu`. An artifact carries the native
op library its program calls, which is loaded and run with it: serve
only artifacts trusted as executables are.

    python -m leod_tpu_torch.cli.export --synthetic --size tiny --cpu --fp32 --out /tmp/m.pt2
    python -m leod_tpu_torch.cli.serve --artifact /tmp/m.pt2 --cpu --port 8000
"""
from __future__ import annotations

import argparse
import base64
import json
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional

import numpy as np

from ..config import derive, experiment_preset
from ..serve import (ServingEngine, artifact_meta, load_artifact_exported,
                     make_serve_step, program_inputs, program_module,
                     serve_input_shape, zero_states_like)
from ._common import device_of, dtype_of, load_detector


def make_server(engine, meta, host: str = "0.0.0.0", port: int = 8000):
    """ThreadingHTTPServer bound to (host, port); port 0 = ephemeral."""
    classes = meta.get("classes", [])
    frame_shape = tuple(meta.get("frame_shape", engine.frame_shape))

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet access log
            pass

        def _reply(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/v1/health":
                self._reply(200, {"status": "ok", **engine.stats(),
                                  "frame_shape": list(frame_shape),
                                  "classes": classes})
            else:
                self._reply(404, {"error": f"no route {self.path}"})

        def do_POST(self):
            if self.path != "/v1/detect":
                self._reply(404, {"error": f"no route {self.path}"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n))
                if not isinstance(req, dict):
                    raise ValueError("body must be a JSON object")
                raw = base64.b64decode(req["frame_b64"])
                frame = np.frombuffer(raw, np.uint8).reshape(frame_shape)
            except (KeyError, TypeError, ValueError,
                    json.JSONDecodeError) as e:
                self._reply(400, {"error": str(e)})
                return
            try:
                dets = engine.detect(str(req.get("stream", "default")),
                                     frame)
            except ValueError as e:             # bad frame shape/dtype
                self._reply(400, {"error": str(e)})
                return
            except Exception as e:  # engine closed / timeout / step crash
                # a JSON 5xx keeps the error contract
                self._reply(503, {"error": f"{type(e).__name__}: {e}"})
                return
            self._reply(200, {"boxes": [[round(float(v), 4) for v in row]
                                        for row in dets],
                              "classes": classes})

    return ThreadingHTTPServer((host, port), Handler)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m leod_tpu_torch.cli.serve")
    ap.add_argument("--artifact", default=None,
                    help="exported .pt2 from cli/export.py")
    ap.add_argument("--ckpt", default=None,
                    help="build the step live from the port's checkpoint "
                         "instead")
    ap.add_argument("--dataset", default="gen1", choices=["gen1", "gen4"])
    ap.add_argument("--size", default="base", choices=["tiny", "small", "base"])
    ap.add_argument("--batch-size", type=int, default=None,
                    help="stream slots (live --ckpt mode only, default 16; "
                         "artifacts carry their exported batch size)")
    ap.add_argument("--conf", type=float, default=None)
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--max-wait-ms", type=float, default=2.0,
                    help="micro-batch coalescing window")
    ap.add_argument("--cpu", action="store_true", help="serve on the CPU")
    ap.add_argument("--fp32", action="store_true")
    return ap


def open_engine(args, ap: argparse.ArgumentParser):
    """(engine, meta) for the parsed flags: over the artifact, or over
    the live step of `--ckpt`'s weights."""
    dev = device_of(args)
    if args.artifact:
        # these knobs are fixed in an exported program: accepting them
        # here would serve other behavior than the operator asked for
        if args.conf is not None or args.fp32 or args.batch_size:
            ap.error("--conf/--fp32/--batch-size are fixed at export "
                     "time; re-export with cli/export.py or serve live "
                     "via --ckpt")
        exported, meta = load_artifact_exported(args.artifact)
        step_fn = program_module(exported, dev)
        states = zero_states_like(exported, device=dev)
        frame_shape = tuple(meta.get("frame_shape")
                            or program_inputs(exported)[1].shape[1:])
    elif args.ckpt:
        batch = args.batch_size or 16
        cfg = derive(experiment_preset(args.dataset, args.size))
        det = load_detector(cfg.model, dtype_of(args), dev, ckpt=args.ckpt)
        step_fn = make_serve_step(det, args.conf, device=dev)
        states = det.init_states(batch)
        frame_shape = serve_input_shape(cfg, batch)[1:]
        meta = artifact_meta(cfg, batch, fold=True,
                             conf_threshold=args.conf)
    else:
        ap.error("need --artifact or --ckpt")
    return ServingEngine(step_fn, states, frame_shape,
                         max_wait_ms=args.max_wait_ms, device=dev), meta


def main(argv: Optional[List[str]] = None) -> None:
    """Serve until interrupted."""
    ap = build_parser()
    args = ap.parse_args(argv)
    engine, meta = open_engine(args, ap)
    server = make_server(engine, meta, args.host, args.port)
    host, port = server.server_address[:2]
    print(f"serving {meta.get('dataset', '?')} on http://{host}:{port} "
          f"({engine.batch_size} stream slots, frame shape "
          f"{engine.frame_shape})", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()
        engine.close()


if __name__ == "__main__":
    main()
