"""Local OpenAI-protocol serving and its client proxy, the port's copy of
gnn_rag_tpu/rag/llms/serving.py (no framework code; the classes line for
line).

It replaces the reference's fastchat subprocess cluster
(llm/src/llms/start_fastchat_api.py:19-53) with a one-process HTTP server
speaking the chat-completions protocol, backed by any registered backend
(``rag.llms``), the on-card ``LlamaTorch`` reader included. The proxy
(llm/src/llms/llm_proxy.py:7-55) is the retrying client.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional


class OpenAIProtocolServer:
    """POST /v1/chat/completions -> {"choices": [{"message": {...}}]}."""

    def __init__(self, model, model_name: str = "local", host: str = "localhost",
                 port: int = 8000):
        self.model = model
        self.model_name = model_name
        self.host = host
        self.port = port
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    def start(self):
        backend = self.model
        model_name = self.model_name

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def do_POST(self):
                if self.path.rstrip("/") != "/v1/chat/completions":
                    self.send_error(404)
                    return
                length = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(length) or b"{}")
                messages = body.get("messages", [])
                prompt = "\n".join(m.get("content", "") for m in messages)
                text = backend.generate_sentence(prompt)
                resp = {
                    "id": "chatcmpl-local",
                    "object": "chat.completion",
                    "created": int(time.time()),
                    "model": body.get("model", model_name),
                    "choices": [{
                        "index": 0,
                        "message": {"role": "assistant", "content": text},
                        "finish_reason": "stop",
                    }],
                }
                payload = json.dumps(resp).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)

            def do_GET(self):
                if self.path.rstrip("/") == "/v1/models":
                    payload = json.dumps({"data": [{"id": model_name}]}).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(payload)))
                    self.end_headers()
                    self.wfile.write(payload)
                else:
                    self.send_error(404)

        self._httpd = ThreadingHTTPServer((self.host, self.port), Handler)
        self.port = self._httpd.server_port
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self):
        if self._httpd:
            self._httpd.shutdown()
            self._httpd = None


class LLMProxy:
    """Retrying chat client against an OpenAI-protocol endpoint
    (llm_proxy.py:33-55); 30s backoff like the reference."""

    def __init__(self, host: str = "localhost", port: int = 8000,
                 model_name: str = "local", api_key: str = "EMPTY"):
        self.base_url = f"http://{host}:{port}/v1"
        self.model_name = model_name
        self.api_key = api_key

    def query(self, message: str, timeout: int = 60, max_retry: int = 3,
              backoff: float = 30.0) -> str:
        import urllib.request
        body = json.dumps({
            "model": self.model_name,
            "messages": [{"role": "user", "content": message}],
        }).encode()
        retry = 0
        while True:
            try:
                req = urllib.request.Request(
                    self.base_url + "/chat/completions", data=body,
                    headers={"Content-Type": "application/json",
                             "Authorization": f"Bearer {self.api_key}"})
                with urllib.request.urlopen(req, timeout=timeout) as r:
                    resp = json.loads(r.read())
                return resp["choices"][0]["message"]["content"].strip()
            except Exception:
                retry += 1
                if retry >= max_retry:
                    raise
                time.sleep(backoff)
