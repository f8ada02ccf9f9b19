"""HTTP serving front end for :class:`aecf_tpu_torch.serve.FusionPredictor`.

Port of :mod:`aecf_tpu.serving_http`, with the same protocol: a
minimal-dependency RPC front (stdlib ``http.server``) on the in-process
bucketed predictor.  A bare predictor is served behind a lock; a
:class:`~aecf_tpu_torch.serve.MicroBatcher` takes concurrent callers and
coalesces them.

Protocol (``POST /v1/predict``):
  * JSON: ``{"image": [[...]], "text": [[...]]}`` → ``{"probs": [[...]],
    "batch": N}``; omit a modality to serve it missing (zeros).
  * Binary: content-type ``application/x-npz`` with an ``.npz`` payload of
    float32 arrays → ``.npz`` response with a ``probs`` array.

``GET /healthz`` → ``{"status": "ok", "modalities": [...]}``.

Usage::

    server = PredictionServer(predictor, port=8000)
    server.start()                       # background thread
    ...
    probs = predict_remote("http://localhost:8000", image=imgs)
    server.stop()
"""

from __future__ import annotations

import io
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import contextlib
import numpy as np

from .serve import MicroBatcher

__all__ = ["PredictionServer", "predict_remote"]


class PredictionServer:
    """Threaded HTTP server wrapping a :class:`FusionPredictor` (or a
    :class:`MicroBatcher` — then concurrent requests coalesce into shared
    device calls instead of serializing behind the lock)."""

    def __init__(
        self,
        predictor,
        *,
        host: str = "127.0.0.1",
        port: int = 8000,
        max_body_bytes: int = 256 * 1024 * 1024,
    ):
        self.predictor = predictor
        self.max_body_bytes = int(max_body_bytes)
        # A MicroBatcher is thread-safe and WANTS concurrent callers (that
        # is what it coalesces); a bare predictor is serialized.
        self._lock = (
            contextlib.nullcontext()
            if isinstance(predictor, MicroBatcher)
            else threading.Lock()
        )
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # quiet by default
                pass

            def _send(self, code, body: bytes, ctype: str):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _send_json(self, code, obj):
                self._send(
                    code, json.dumps(obj).encode(), "application/json"
                )

            def do_GET(self):
                if self.path == "/healthz":
                    self._send_json(
                        200,
                        {
                            "status": "ok",
                            "modalities": list(
                                outer.predictor.modality_names
                            ),
                        },
                    )
                else:
                    self._send_json(404, {"error": "not found"})

            def do_POST(self):
                if self.path != "/v1/predict":
                    self._send_json(404, {"error": "not found"})
                    return
                try:
                    length = int(self.headers.get("Content-Length", 0))
                    if length > outer.max_body_bytes:
                        # bound host memory BEFORE buffering the body: one
                        # oversized request must not OOM the process and
                        # take every in-flight request with it
                        self._send_json(
                            413,
                            {
                                "error": (
                                    f"request body {length} bytes exceeds "
                                    f"limit {outer.max_body_bytes}"
                                )
                            },
                        )
                        return
                    raw = self.rfile.read(length)
                    ctype = self.headers.get("Content-Type", "")
                    if ctype.startswith("application/x-npz"):
                        try:
                            blob = np.load(io.BytesIO(raw))
                            mods = {
                                k: np.asarray(blob[k]) for k in blob.files
                            }
                        except Exception as e:  # noqa: BLE001
                            # zipfile.BadZipFile / pickle rejection / ...:
                            # a malformed CLIENT payload is a 400, not a
                            # 500 (keeps 5xx alerting honest)
                            raise ValueError(
                                f"invalid .npz payload: {e}"
                            ) from None
                        with outer._lock:
                            probs = outer.predictor(**mods)
                        buf = io.BytesIO()
                        np.savez(buf, probs=probs)
                        self._send(
                            200, buf.getvalue(), "application/x-npz"
                        )
                    else:
                        payload = json.loads(raw)
                        if not isinstance(payload, dict):
                            # a malformed CLIENT request is a 400, not a
                            # 500 (keeps 5xx alerting honest)
                            raise ValueError(
                                "request body must be a JSON object of "
                                f"modalities, got {type(payload).__name__}"
                            )
                        mods = {
                            k: np.asarray(v, np.float32)
                            for k, v in payload.items()
                        }
                        with outer._lock:
                            probs = outer.predictor(**mods)
                        self._send_json(
                            200,
                            {
                                "probs": probs.tolist(),
                                "batch": int(probs.shape[0]),
                            },
                        )
                except ValueError as e:
                    self._send_json(400, {"error": str(e)})
                except Exception as e:  # noqa: BLE001 — serving boundary
                    self._send_json(
                        500, {"error": f"{type(e).__name__}: {e}"}
                    )

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._thread: Optional[threading.Thread] = None
        self._serving = False

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def start(self) -> "PredictionServer":
        """Serve in a daemon thread; returns self."""
        self._serving = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True
        )
        self._thread.start()
        return self

    def serve_forever(self) -> None:
        self._serving = True
        self._httpd.serve_forever()

    def stop(self) -> None:
        # BaseServer.shutdown() blocks on an event that is only set when
        # serve_forever EXITS — calling it on a never-started server (e.g.
        # from a finally block after a startup failure) would deadlock.
        if self._serving:
            self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)


def predict_remote(
    url: str, *, binary: bool = True, timeout: float = 60.0,
    **modalities: np.ndarray,
) -> np.ndarray:
    """Client helper: POST modalities to a :class:`PredictionServer`.

    ``binary=True`` ships/receives ``.npz`` (preferred for real batches);
    ``binary=False`` uses JSON.
    """
    import urllib.request

    endpoint = url.rstrip("/") + "/v1/predict"
    if binary:
        buf = io.BytesIO()
        np.savez(
            buf,
            **{k: np.asarray(v, np.float32) for k, v in modalities.items()},
        )
        req = urllib.request.Request(
            endpoint,
            data=buf.getvalue(),
            headers={"Content-Type": "application/x-npz"},
        )
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            blob = np.load(io.BytesIO(resp.read()))
            return np.asarray(blob["probs"])
    req = urllib.request.Request(
        endpoint,
        data=json.dumps(
            {k: np.asarray(v).tolist() for k, v in modalities.items()}
        ).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return np.asarray(json.loads(resp.read())["probs"], np.float32)
