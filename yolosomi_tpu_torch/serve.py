"""REST detection server (counterpart of the root serve.py of the JAX
package, :39-164; the reference's utils/flask_rest_api/).

    python -m yolosomi_tpu_torch.serve --cfg yolo-somi --weights somi.msgpack --port 5000 [--device cpu]
    curl -X POST -T drone.jpg http://localhost:5000/v1/object-detection/somi

POST an image (raw bytes, or multipart/form-data) to
/v1/object-detection/<model> and get JSON records
[{xmin, ymin, xmax, ymax, confidence, class, name}, ...], the keys, types
and order of the JAX server's `pandas()` records, built without pandas
(Detections.records). GET /healthz answers {"status": "ok"}.

The stdlib ThreadingHTTPServer runs each request on a thread of its own;
one worker thread owns the model and the device, and requests queue for it.
"""

from __future__ import annotations

import argparse
import json
import queue
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import cv2
import numpy as np

from yolosomi_tpu_torch.api import load
from yolosomi_tpu_torch.utils.general import LOGGER


def parse_multipart_image(raw: bytes, content_type: str):
    """The uploaded file of a multipart/form-data body (RFC 2046, through
    the stdlib email parser): the first part with a filename or an image/*
    type, else the first part with a payload. None when the body does not
    parse as multipart."""
    import email.parser
    import email.policy

    try:
        msg = email.parser.BytesParser(policy=email.policy.default).parsebytes(
            b"Content-Type: " + content_type.encode("latin-1") + b"\r\n\r\n" + raw
        )
    except (ValueError, TypeError, UnicodeError):
        return None
    if not msg.is_multipart():
        return None
    first = None
    for part in msg.iter_parts():
        payload = part.get_payload(decode=True)
        if not payload:
            continue
        if part.get_filename() or part.get_content_type().startswith("image/"):
            return payload
        if first is None:
            first = payload
    return first


class DetectionServer(ThreadingHTTPServer):
    """An HTTP server around `model` (an AutoShape): requests hand their
    decoded image to one worker thread, which owns the device. `close()`
    stops the worker and the socket."""

    daemon_threads = True

    def __init__(self, address, model):
        super().__init__(address, Handler)
        self.model = model
        self.jobs: queue.Queue = queue.Queue()
        self.worker = threading.Thread(target=self._work, daemon=True, name="detect-worker")
        self.worker.start()

    def _work(self):
        while True:
            job = self.jobs.get()
            if job is None:
                return
            img, out = job
            try:
                out["records"] = self.model(img).records()[0]
            except Exception as e:  # noqa: BLE001 - handed to the request thread, which answers 500
                LOGGER.exception("serve: inference failed")
                out["error"] = str(e)
            finally:
                out["done"].set()

    def infer(self, img) -> list:
        """The records of one image, computed on the worker thread."""
        out = {"done": threading.Event()}
        self.jobs.put((img, out))
        out["done"].wait()
        if "error" in out:
            raise RuntimeError(out["error"])
        return out["records"]

    def close(self):
        self.jobs.put(None)
        self.worker.join(timeout=30)
        self.server_close()


class Handler(BaseHTTPRequestHandler):
    def _send(self, code: int, payload):
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        if self.path == "/healthz":
            self._send(200, {"status": "ok"})
        else:
            self._send(404, {"error": "POST an image to /v1/object-detection/<model>"})

    def do_POST(self):
        if not self.path.startswith("/v1/object-detection/"):
            self._send(404, {"error": "unknown route"})
            return
        try:
            raw = self.rfile.read(int(self.headers.get("Content-Length", 0)))
            if not raw:
                self._send(400, {"error": "empty body"})
                return
            ctype = self.headers.get("Content-Type", "")
            if ctype.lower().startswith("multipart/"):
                raw = parse_multipart_image(raw, ctype)
                if raw is None:
                    self._send(400, {"error": "could not parse multipart body"})
                    return
            img = cv2.imdecode(np.frombuffer(raw, np.uint8), cv2.IMREAD_COLOR)
            if img is None:
                self._send(400, {"error": "could not decode image"})
                return
            self._send(200, self.server.infer(img))
        except Exception as e:  # noqa: BLE001 - any failure is answered with a 500
            LOGGER.exception("serve: request failed")
            self._send(500, {"error": str(e)})

    def log_message(self, fmt, *args):
        LOGGER.info("serve: " + fmt % args)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--cfg", default="yolo-somi")
    parser.add_argument("--weights", default=None)
    parser.add_argument("--imgsz", type=int, default=640)
    parser.add_argument("--conf", type=float, default=0.25)
    parser.add_argument("--port", type=int, default=5000)
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--device", type=str, default="cuda", help="torch device: cuda, cuda:1 or cpu")
    args = parser.parse_args(argv)

    model = load(args.cfg, args.weights, imgsz=args.imgsz, conf=args.conf, device=args.device)
    model(np.zeros((320, 320, 3), np.uint8))  # warm-up: cuDNN plans, the allocator
    server = DetectionServer((args.host, args.port), model)
    LOGGER.info(f"serving on http://{args.host}:{args.port}/v1/object-detection/model")
    try:
        server.serve_forever()
    finally:
        server.close()


if __name__ == "__main__":
    main()
