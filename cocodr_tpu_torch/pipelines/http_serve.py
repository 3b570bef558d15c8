"""HTTP serving with dynamic batching and pipelined readback: the
counterpart of cocodr_tpu/pipelines/http_serve.py, standard library only.

`serve --http PORT` wraps a `RetrievalService` in a ThreadingHTTPServer.
Concurrent requests do not each pay a batch: handler threads enqueue into
a dispatcher that coalesces everything waiting (up to `max_batch`, within
a short collection window) into one `service.dispatch` call.

Two threads own the card work. The dispatcher thread calls
`service.dispatch`, which tokenizes, encodes and enqueues the search
(`dispatch` enters torch.inference_mode itself: that mode is per thread).
The reader thread calls `service.collect_many`, whose copies of the
[batch, k] results to the host are what wait for the card. Up to `depth`
batches ride between them, so the host work of batch i + 1 overlaps the
card's work on batch i, as in `search_stream`.

Hardening:
  * request bodies above `max_body_bytes` are rejected 413 before read
  * the pending-request queue is bounded: a flooded server answers 503
    (Retry-After) instead of buffering without limit
  * every request carries a timeout -> 504

API:
  GET  /healthz            -> {"ok": true, "n_docs": N, "batches": ...,
                               "requests": ...}
  POST /search             body {"query": "...", "k": 10}
                           or   {"queries": [...], "k": 10}
       -> {"hits": [[{"id": ..., "score": ...}, ...] per query]}
       (the single-query form returns {"hits": [ ... one list ... ]})
       k defaults to the service's top_k and may be up to max(top_k,
       MAX_K); a batch is searched at the largest k of its requests.
       (The JAX server caps a batch's k at top_k, so a request for more
       gets top_k hits; its sharded service is compiled for top_k, and the
       port has no sharded service.)
"""
from __future__ import annotations

import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

# the largest k a request may ask for above the service's top_k (K3
# serves k = 1000 on the search paths, as the evaluation does)
MAX_K = 1000


class _Request:
    """One HTTP request's query group: all its texts, one Event. A group
    is one queue item and one Event, not one per query; the dispatcher
    slices it across batches when it spans a max_batch boundary (`done`
    counts completed rows; only the reader thread changes it)."""

    __slots__ = ("texts", "k", "event", "hits", "error", "done")

    def __init__(self, texts, k: int):
        self.texts = texts
        self.k = k
        self.event = threading.Event()
        self.hits = [None] * len(texts)
        self.error = None
        self.done = 0


class QueueFullError(Exception):
    pass


class Batcher:
    """Coalesces concurrent query groups into batched dispatches and
    pipelines their readback.

    The dispatcher collects waiting requests (window_s bounds the latency
    added for the second and later arrivals of a batch) and issues
    `service.dispatch` calls; the reader waits on `service.collect_many`
    for what is in flight and completes its requests.

    queue_max bounds the waiting queries (admission control): a submit
    that would push the waiting total past it fails with QueueFullError
    after a short grace wait (the HTTP layer answers 503). A group larger
    than queue_max is refused outright."""

    def __init__(self, service, window_s: float = 0.002, depth: int = 8,
                 queue_max: int = 4096):
        self.service = service
        self.window_s = window_s
        self.queue_max = queue_max
        self.q: "queue.Queue" = queue.Queue()
        self.inflight: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
        self.batches = 0  # dispatches issued
        self.requests = 0  # queries dispatched
        self._stop = False
        self._cond = threading.Condition()
        self._waiting = 0  # queries admitted but not yet dispatched
        self._dispatcher = threading.Thread(target=self._loop, daemon=True)
        self._reader = threading.Thread(target=self._read_loop, daemon=True)
        self._dispatcher.start()
        self._reader.start()

    def submit_many(self, texts, k: int, timeout: Optional[float] = 60.0):
        """One queue item and one Event for the whole group. Raises
        QueueFullError when admission stays blocked (all or nothing), and
        TimeoutError when the results do not come within timeout, and
        RuntimeError once the batcher is stopping."""
        if not texts:
            return []
        req = _Request(list(texts), k)
        self._admit(req)
        if not req.event.wait(timeout):
            raise TimeoutError("search timed out")
        if req.error is not None:
            raise RuntimeError(req.error)
        return req.hits

    def _admit(self, req: _Request, grace_s: float = 0.25):
        """Counts the group in and queues it, under the lock stop() takes:
        no group is queued behind stop's wake-up item, so the dispatcher
        serves every admitted group before it ends."""
        n = len(req.texts)
        deadline = time.time() + grace_s
        with self._cond:
            while not self._stop and self._waiting + n > self.queue_max:
                remaining = deadline - time.time()
                if remaining <= 0:
                    raise QueueFullError("request queue saturated")
                self._cond.wait(remaining)
            if self._stop:
                raise RuntimeError("server stopping")
            self._waiting += n
            self.q.put((req, 0))

    def _drained(self, n: int):
        with self._cond:
            self._waiting -= n
            self._cond.notify_all()

    def stop(self):
        """Refuses new groups, serves those already queued, and ends both
        threads."""
        with self._cond:
            self._stop = True
            self.q.put(None)  # wake the dispatcher, after every group
            self._cond.notify_all()
        # the dispatcher ends the reader with a None after its last batch
        self._dispatcher.join(timeout=5)
        self._reader.join(timeout=5)

    def _loop(self):
        max_batch = self.service.cfg.max_batch
        carry = None  # (req, start): a group's slice past max_batch
        while True:
            if carry is not None:
                first, carry = carry, None
            else:
                first = self.q.get()
                if first is None:
                    self.inflight.put(None)
                    return
            # parts: the (req, start, end) row slices making up this batch
            req, start = first
            take = min(len(req.texts) - start, max_batch)
            parts = [(req, start, start + take)]
            n = take
            if start + take < len(req.texts):
                carry = (req, start + take)
            deadline = time.time() + self.window_s
            stopping = False
            while n < max_batch and carry is None:
                remaining = deadline - time.time()
                try:
                    item = self.q.get(
                        timeout=max(0.0, remaining)
                    ) if remaining > 0 else self.q.get_nowait()
                except queue.Empty:
                    break
                if item is None:
                    stopping = True
                    break
                req, start = item
                take = min(len(req.texts) - start, max_batch - n)
                parts.append((req, start, start + take))
                n += take
                if start + take < len(req.texts):
                    carry = (req, start + take)
            self._drained(n)
            self._dispatch(parts, n)
            if stopping:
                self.inflight.put(None)
                return

    def _dispatch(self, parts, n):
        self.batches += 1
        self.requests += n
        k = max(r.k for r, _, _ in parts)
        texts = []
        for r, s, e in parts:
            texts.extend(r.texts[s:e])
        try:
            pending = self.service.dispatch(texts, k)
        except Exception as e:  # reported to each request of the batch
            for r, _, _ in parts:
                r.error = f"{type(e).__name__}: {e}"
                r.event.set()
            return
        # blocks when `depth` batches are in flight: backpressure into
        # the request queue
        self.inflight.put((parts, k, pending))

    def _read_loop(self):
        stop = False
        while not stop:
            # collect everything in flight in one call: the first copy
            # waits for the card, the rest are ready by then
            group = [self.inflight.get()]
            while True:
                try:
                    group.append(self.inflight.get_nowait())
                except queue.Empty:
                    break
            if None in group:
                stop = True
                group = [g for g in group if g is not None]
            if not group:
                return
            try:
                results = self.service.collect_many([p for _, _, p in group])
            except Exception as e:  # reported to each request of the group
                for parts, _, _ in group:
                    for r, _, _ in parts:
                        r.error = f"{type(e).__name__}: {e}"
                        r.event.set()
                continue
            for (parts, k, _), (vals, ids) in zip(group, results):
                row = 0
                for r, s, e in parts:
                    kk = min(r.k, k)
                    for j in range(s, e):
                        vrow = vals[row, :kk].tolist()
                        irow = ids[row][:kk]
                        r.hits[j] = [
                            {"id": d if isinstance(d, (int, type(None)))
                             else str(d), "score": v}
                            for d, v in zip(irow, vrow)
                        ]
                        row += 1
                    r.done += e - s
                    if r.done == len(r.texts):
                        r.event.set()


def make_server(service, host: str = "127.0.0.1", port: int = 8080,
                window_s: float = 0.002, depth: int = 8,
                queue_max: int = 4096,
                max_body_bytes: int = 1 << 20,
                request_timeout_s: float = 60.0):
    """-> (ThreadingHTTPServer, Batcher). The caller runs
    server.serve_forever() (or in a thread), then server.shutdown(),
    batcher.stop() and server.server_close()."""
    batcher = Batcher(service, window_s=window_s, depth=depth,
                      queue_max=queue_max)
    kmax = max(service.cfg.top_k, MAX_K)

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # no access log
            pass

        def _json(self, code: int, obj, headers=()):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            for k, v in headers:
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, {
                    "ok": True,
                    "n_docs": service.n_docs,
                    "batches": batcher.batches,
                    "requests": batcher.requests,
                })
            else:
                self._json(404, {"error": "not found"})

        def do_POST(self):
            if self.path != "/search":
                self._json(404, {"error": "not found"})
                return
            try:
                try:
                    length = int(self.headers.get("Content-Length", 0))
                except ValueError:
                    self._json(411, {"error": "invalid Content-Length"})
                    return
                if length > max_body_bytes:
                    # refused before reading: one large POST must not
                    # allocate without bound
                    self._json(413, {
                        "error": f"body exceeds {max_body_bytes} bytes"
                    })
                    return
                try:
                    req = json.loads(self.rfile.read(length) or b"{}")
                except ValueError:
                    self._json(400, {"error": "invalid JSON body"})
                    return
                if not isinstance(req, dict):
                    self._json(400, {"error": "body must be an object"})
                    return
                k = req.get("k", service.cfg.top_k)
                if (not isinstance(k, int) or isinstance(k, bool)
                        or not 1 <= k <= kmax):
                    self._json(400, {
                        "error": f"k must be an int in [1, {kmax}]"
                    })
                    return
                if "queries" in req:
                    if not isinstance(req["queries"], list):
                        self._json(400, {"error": "'queries' must be a list"})
                        return
                    texts = [str(t) for t in req["queries"]]
                    single = False
                elif "query" in req:
                    texts = [str(req["query"])]
                    single = True
                else:
                    self._json(400, {"error": "need 'query' or 'queries'"})
                    return
                hits = batcher.submit_many(
                    texts, k, timeout=request_timeout_s
                )
                self._json(200, {"hits": hits[0] if single else hits})
            except QueueFullError:
                self._json(503, {"error": "server saturated"},
                           headers=(("Retry-After", "1"),))
            except TimeoutError:
                self._json(504, {"error": "search timed out"})
            except Exception as e:  # the server keeps answering
                self._json(500, {"error": f"{type(e).__name__}: {e}"})

    server = ThreadingHTTPServer((host, port), Handler)
    server.batcher = batcher
    return server, batcher
