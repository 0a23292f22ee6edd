"""Online retrieval serving: query text -> encoded -> index search -> passages.

Counterpart of :mod:`dpr_scale_tpu.retrieve.server` (the dense tower and
the CITADEL tower), with the same HTTP API and JSON:

    POST /search           {"questions": [...], "k": 10}   (dense)
    POST /search_citadel   {"questions": [...], "k": 10}   (multi-vector)
      -> {"results": [[{"id", "title", "text", "score"}, ...], ...]}
    GET /healthz   -> {"status": "ok", "corpus_rows": N, "towers": [...]}

Concurrency is the JAX package's coalescing worker: concurrent callers
merge into one padded device batch (bounded by ``coalesce_wait_ms`` after
the first request); by default (``serialized=True``) each coalesced group
runs tokenize -> encode -> search on the encode worker, and the opt-in
two-stage mode overlaps the next group's encode with this group's search.
Queries pad to power-of-two batch buckets and k rounds up to a power of
two, as there. The workers are threads, and ``torch.inference_mode`` is
thread-local, so the encoder and the index enter it on the worker itself.
"""
from __future__ import annotations

import json
import queue as _queue
import threading
import time
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional

import numpy as np

from dpr_scale_tpu_torch.retrieve.retrieval import rows_to_ctxs


class _Pending:
    __slots__ = ("texts", "k_searched", "event", "scores", "rows", "error")

    def __init__(self, texts, k_searched):
        self.texts = texts
        self.k_searched = k_searched
        self.event = threading.Event()
        self.scores = self.rows = self.error = None


class _CoalescingPipeline:
    """Encode/search pipeline. Subclasses implement ``_encode_chunk(texts)
    -> payload`` (one <= max_batch chunk), ``_search_payload(payload, k) ->
    (scores, rows)`` (host numpy) and ``num_rows``."""

    def __init__(
        self,
        passages,  # CSVDataset
        default_k: int = 10,
        max_batch: int = 64,
        max_k: int = 1000,
        coalesce_wait_ms: float = 2.0,
        search_queue_depth: int = 2,
        serialized: bool = True,
    ):
        self.passages = passages
        self.default_k = default_k
        self.max_batch = max_batch
        self.max_k = max_k
        self.coalesce_wait_ms = coalesce_wait_ms
        self.serialized = serialized  # read per group: may flip on a live pipeline
        self._encode_q: _queue.Queue = _queue.Queue()
        self._search_q: _queue.Queue = _queue.Queue(maxsize=search_queue_depth)
        self._workers_started = False
        self._worker_lock = threading.Lock()
        # one group searches at a time, whichever worker runs it
        self._search_group_lock = threading.Lock()

    @property
    def num_rows(self) -> int:
        raise NotImplementedError

    def _encode_chunk(self, texts: List[str]):
        raise NotImplementedError

    def _search_payload(self, payload, k: int):
        raise NotImplementedError

    def _pad_batch(self, n: int) -> int:
        return min(self.max_batch, max(8, 1 << (n - 1).bit_length()))

    def _run_one(self, texts: List[str], k_searched: int):
        """One request alone, chunked (the isolation/retry path)."""
        all_s, all_r = [], []
        for lo in range(0, len(texts), self.max_batch):
            chunk = texts[lo : lo + self.max_batch]
            s, r = self._search_payload(self._encode_chunk(chunk), k_searched)
            all_s.append(s[: len(chunk)])
            all_r.append(r[: len(chunk)])
        return np.concatenate(all_s), np.concatenate(all_r)

    def _isolate(self, batch: List[_Pending]):
        """A poisoned request coalesced with healthy ones must not fail
        unrelated callers: retry each request alone."""
        for r in batch:
            try:
                r.scores, r.rows = self._run_one(r.texts, r.k_searched)
            except Exception as e_r:  # noqa: BLE001 — handed to the caller
                r.error = e_r
            r.event.set()

    def _encode_worker(self):
        while True:
            first = self._encode_q.get()
            batch = [first]
            n = len(first.texts)
            deadline = time.perf_counter() + self.coalesce_wait_ms / 1e3
            while n < self.max_batch:
                left = deadline - time.perf_counter()
                if left <= 0:
                    break
                try:
                    nxt = self._encode_q.get(timeout=left)
                except _queue.Empty:
                    break
                batch.append(nxt)
                n += len(nxt.texts)
            texts = [t for r in batch for t in r.texts]
            k_s = max(r.k_searched for r in batch)
            try:
                payloads = [
                    (
                        self._encode_chunk(texts[lo : lo + self.max_batch]),
                        min(self.max_batch, len(texts) - lo),
                    )
                    for lo in range(0, len(texts), self.max_batch)
                ]
            except Exception:  # noqa: BLE001 — retried per request
                self._isolate(batch)
                continue
            if self.serialized:
                self._search_group(batch, payloads, k_s)
            else:
                self._search_q.put((batch, payloads, k_s))  # blocks: back-pressure

    def _search_group(self, batch, payloads, k_s):
        with self._search_group_lock:
            try:
                all_s, all_r = [], []
                for payload, n_real in payloads:
                    s, r = self._search_payload(payload, k_s)
                    all_s.append(s[:n_real])
                    all_r.append(r[:n_real])
                scores = np.concatenate(all_s)
                rows = np.concatenate(all_r)
                off = 0
                for r in batch:
                    m = len(r.texts)
                    r.scores, r.rows = scores[off : off + m], rows[off : off + m]
                    off += m
                    r.event.set()
            except Exception as e:  # noqa: BLE001 — handed to the caller
                if len(batch) == 1:
                    batch[0].error = e
                    batch[0].event.set()
                else:
                    self._isolate(batch)

    def _search_worker(self):
        while True:
            self._search_group(*self._search_q.get())

    def _ensure_workers(self):
        if not self._workers_started:
            with self._worker_lock:
                if not self._workers_started:
                    for target in (self._encode_worker, self._search_worker):
                        threading.Thread(target=target, daemon=True).start()
                    self._workers_started = True

    def search(self, questions: List[str], k: Optional[int] = None) -> List[List[dict]]:
        if not questions:
            return []
        k = k or self.default_k
        k = min(k, self.max_k, self.num_rows)
        # the searched k rounds up to a power of two (few distinct shapes)
        k_searched = min(1 << max(0, k - 1).bit_length(), self.max_k, self.num_rows)
        self._ensure_workers()
        req = _Pending(list(questions), k_searched)
        self._encode_q.put(req)
        req.event.wait()
        if req.error is not None:
            raise req.error
        # passage fetch on the caller's thread, off the device pipeline
        return rows_to_ctxs(self.passages, req.scores[:, :k], req.rows[:, :k])


class Retriever(_CoalescingPipeline):
    """Dense-tower serving: the query tower encodes, the exact MIPS index
    searches; thread-safe."""

    def __init__(self, encoder, tokenizer, index, passages, **kwargs):
        super().__init__(passages, **kwargs)
        self.encoder = encoder  # CorpusEncoder with use_query_tower=True
        self.tokenizer = tokenizer
        self.index = index  # MipsIndex

    @property
    def num_rows(self) -> int:
        return self.index.num_rows

    def _encode_chunk(self, texts: List[str]):
        pad_b = self._pad_batch(len(texts))
        ids, mask = self.tokenizer(texts + [""] * (pad_b - len(texts)))
        # stays on the device: MipsIndex.search takes the tensor as it is
        return self.encoder.encode(ids, mask)

    def _search_payload(self, payload, k: int):
        return self.index.search(payload, k)


class CitadelRetriever(_CoalescingPipeline):
    """Multi-vector (CITADEL / COIL / ColBERT) serving behind the same
    coalescing pipeline: the encoder routes the queries' tokens to experts
    and the inverted expert index (host or device) scores them; thread-safe.
    The index routes on host numpy, so the encoder's outputs are fetched on
    the encode worker, pad rows trimmed."""

    def __init__(
        self,
        model,  # MultiVecEncoder, on its device in eval mode
        tokenizer,
        index,  # InvertedExpertIndex or DeviceExpertIndex
        passages,
        topk_route: int = 1,
        add_cls: bool = False,
        **kwargs,
    ):
        super().__init__(passages, **kwargs)
        self.model = model
        self.tokenizer = tokenizer
        self.index = index
        self.topk_route = topk_route
        self.add_cls = add_cls
        self.device = next(model.parameters()).device

    @property
    def num_rows(self) -> int:
        return self.index.num_docs

    def _encode_chunk(self, texts: List[str]):
        import torch

        pad_b = self._pad_batch(len(texts))
        ids, mask = self.tokenizer(texts + [""] * (pad_b - len(texts)))
        with torch.inference_mode():
            out = self.model(
                torch.from_numpy(np.asarray(ids)).to(self.device),
                torch.from_numpy(np.asarray(mask)).to(self.device),
                topk=self.topk_route, add_cls=self.add_cls,
                routing_stats=False,  # training-only (B, vocab) planes
            )
            out = {k: v.cpu().numpy() for k, v in out.items()}
        n = len(texts)
        return {k: (v[:n] if v.ndim > 0 else v) for k, v in out.items()}

    def _search_payload(self, payload, k: int):
        scores, rows = self.index.search(payload, topk=k)
        return np.asarray(scores), np.asarray(rows)


MAX_QUESTIONS_PER_REQUEST = 1024
MAX_BODY_BYTES = 16 * 1024 * 1024


def make_server(
    retriever: Optional[_CoalescingPipeline],
    host: str = "0.0.0.0",
    port: int = 8080,
    citadel_retriever: Optional[CitadelRetriever] = None,
):
    """An HTTP server with ``/search`` (``retriever``) and / or
    ``/search_citadel`` (``citadel_retriever``); at least one is needed."""
    routes = {}
    if retriever is not None:
        routes["/search"] = retriever
    if citadel_retriever is not None:
        routes["/search_citadel"] = citadel_retriever
    if not routes:
        raise ValueError("at least one retriever required")
    primary = retriever if retriever is not None else citadel_retriever

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):  # quiet
            pass

        def _reply(self, code: int, payload: dict):
            body = json.dumps(payload).encode("utf-8")
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._reply(
                    200,
                    {
                        "status": "ok",
                        "corpus_rows": primary.num_rows,
                        "towers": sorted(routes),
                    },
                )
            else:
                self._reply(404, {"error": "unknown path"})

        def do_POST(self):
            target = routes.get(self.path)
            if target is None:
                self._reply(404, {"error": "unknown path"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                if length > MAX_BODY_BYTES:
                    self._reply(413, {"error": "request body too large"})
                    return
                req = json.loads(self.rfile.read(length) or b"{}")
                questions = req.get("questions")
                if not isinstance(questions, list) or not questions:
                    self._reply(400, {"error": "questions must be a non-empty list"})
                    return
                if len(questions) > MAX_QUESTIONS_PER_REQUEST:
                    self._reply(
                        400,
                        {"error": f"at most {MAX_QUESTIONS_PER_REQUEST} questions per request"},
                    )
                    return
                k = req.get("k")
                if k is not None and (not isinstance(k, int) or k <= 0):
                    self._reply(400, {"error": "k must be a positive integer"})
                    return
                if k is not None and k > target.max_k:
                    self._reply(400, {"error": f"k must be at most {target.max_k}"})
                    return
                results = target.search([str(q) for q in questions], k)
                self._reply(200, {"results": results})
            except json.JSONDecodeError:
                self._reply(400, {"error": "invalid JSON body"})
            except Exception:  # noqa: BLE001 — the server keeps serving
                traceback.print_exc()  # server log; clients get no internals
                self._reply(500, {"error": "internal error"})

    return ThreadingHTTPServer((host, port), Handler)
