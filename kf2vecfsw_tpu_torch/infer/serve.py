"""Persistent serving daemon: a JSON-lines request loop over device-resident
caches (the port's ``kf2vec serve``; the JAX package's ``infer/serve.py``).

A one-shot ``process_query_data`` pays, every time, for reading and building
the classifier and every touched subtree model, shipping them to the card,
and parsing the anchor CSVs. The models do not change between requests; a
resident process pays once (``infer/cache.py``) and then answers at the
parse + compute floor.

Protocol: one JSON object per line on stdin, one JSON response line per
request on stdout (pipeline logs go to stderr, so stdout carries nothing but
the protocol):

  {"cmd": "ping"}
      -> {"ok": true, "pong": true}
  {"cmd": "warm"}
      -> ship the classifier and every subtree model and anchor set to the
         device, run one forward per distinct (kind, shapes) at one block,
         and on the card build and load both kernel libraries, so the first
         placement pays no cuBLAS, module-load or nvcc cost; the reply
         reports models touched, forwards run ("compiled") and resident bytes.
         {"compile": false} skips the forwards.
  {"cmd": "stats"}
      -> cache hit/miss and residency counters, requests served
  {"cmd": "place", "input_dir": DIR, "output_dir": DIR}
      -> the whole pipeline on raw FASTA/FASTQ: get_frequencies, classify,
         get_kmers (once per k of the library's FSW models), query; the
         reply lists the written outputs. Optional: "k" (overrides -k for
         the features), "remap" (label-remap .tsv, as `query -remap`)
  {"cmd": "place_features", "features_dir": DIR, "output_dir": DIR}
      -> classify + query on extracted features (.kf and, for FSW
         libraries, {name}_k{k}.npy). Optional: "remap"
  {"cmd": "quit"}
      -> {"ok": true, "bye": true} and exit (EOF exits too)

On start the daemon emits {"ok": true, "event": "ready", ...}, so clients
can block on readiness. A failing request gets {"ok": false, "error": ...}
and the loop keeps serving.

Per-request watchdog (-request_timeout T / KF2VEC_SERVE_REQUEST_TIMEOUT_S;
warm gets at least KF2VEC_SERVE_WARM_TIMEOUT_S, default 900): with a
timeout set, each handler runs on a worker thread; a request past T is
answered {"ok": false, "timeout": true, ...} and the daemon goes on. A
device call that never returns cannot be interrupted from Python, so the
worker is abandoned; before answering, the watchdog sets the request's
cancel flag (``utils/cancel.py``), and every stage the request runs writes
its output files only under that flag, so the abandoned worker writes
nothing after the reply. 0 (default) disables the watchdog.
"""

from __future__ import annotations

import glob
import json
import os
import sys
import threading
import time

import torch

from ..device import DEFAULT_DEVICE, resolve_device
from ..utils.cancel import CancelFlag


class ServeDaemon:
    def __init__(self, args):
        self.args = args
        self.device = resolve_device(getattr(args, "device", DEFAULT_DEVICE))
        self.requests = 0
        self.timeouts = 0
        self.started = time.time()
        self._local = threading.local()  # .cancel: the flag of the request on this thread
        # explicit flag > env > disabled
        t = float(getattr(args, "request_timeout", 0.0) or 0.0)
        if t <= 0:
            t = float(os.environ.get("KF2VEC_SERVE_REQUEST_TIMEOUT_S", "0") or 0)
        self.request_timeout_s = t if t > 0 else 0.0

    def _cancel_flag(self) -> CancelFlag | None:
        return getattr(self._local, "cancel", None)

    # -- request handlers ----------------------------------------------------

    def handle_ping(self, req: dict) -> dict:
        return {"ok": True, "pong": True}

    def handle_stats(self, req: dict) -> dict:
        from .cache import cache_stats

        return {
            "ok": True,
            "requests": self.requests,
            "request_timeouts": self.timeouts,
            "uptime_s": round(time.time() - self.started, 1),
            "caches": cache_stats(),
        }

    def handle_warm(self, req: dict) -> dict:
        """Ship the classifier and every subtree model and anchor set to the
        device, then run one forward per distinct (kind, shapes) at one
        block and, on the card, build and load both kernel libraries."""
        from ..kmer.vocab import canonical_vocab_size
        from ..train.checkpoint import fsw_k_from_meta
        from .cache import cache_stats, cached_checkpoint, cached_embeddings
        from .query import fused_forward

        dev = self.device
        t0 = time.time()
        touched = 0
        compiled = 0
        precompile = bool(req.get("compile", True))
        done_shapes: set = set()
        with torch.no_grad():
            cls = os.path.join(self.args.classifier_model, "classifier_model.ckpt")
            if os.path.exists(cls):
                _, _, model = cached_checkpoint(cls, dev)
                touched += 1
                if precompile:
                    model(torch.zeros((1, model.fc1.in_features), device=dev))
                    compiled += 1
            for ckpt in sorted(
                glob.glob(os.path.join(self.args.distance_model, "model_subtree_*.ckpt"))
            ):
                model_name, meta, model = cached_checkpoint(ckpt, dev)
                touched += 1
                stem = os.path.basename(ckpt)[len("model_subtree_") : -len(".ckpt")]
                emb = os.path.join(self.args.distance_model, f"embeddings_subtree_{stem}.csv")
                if not os.path.exists(emb):
                    continue
                _, anchors = cached_embeddings(emb, dev)
                if not precompile:
                    continue
                param_shapes = tuple(tuple(p.shape) for p in model.parameters())
                if model_name == "NeuralNetFSW":
                    k = fsw_k_from_meta(meta)
                    if not 1 <= k <= 9:
                        continue  # geometric-bucket point sets: no one block shape
                    shape_key = ("fsw", k, tuple(anchors.shape), param_shapes)
                    x = torch.zeros((1, canonical_vocab_size(k), k + 1), device=dev)
                else:
                    shape_key = ("dense", tuple(anchors.shape), param_shapes)
                    x = torch.zeros((1, model.fc1.in_features), device=dev)
                if shape_key in done_shapes:
                    continue
                fused_forward(model, x, anchors)
                done_shapes.add(shape_key)
                compiled += 1
        if dev.type == "cuda":
            from ..kernels import histogram, sort

            histogram._lib()
            sort._lib()
            torch.cuda.synchronize(dev)
        stats = cache_stats()
        return {
            "ok": True,
            "models": touched,
            "compiled": compiled,
            "seconds": round(time.time() - t0, 3),
            "device_bytes": stats["checkpoints"]["device_bytes"]
            + stats["anchors"]["device_bytes"],
        }

    def handle_place(self, req: dict) -> dict:
        """Raw-FASTA placement: feature extraction + classify + query (the
        stages of the process_query_data wrapper, cli.py)."""
        from ..ingest.frequencies import get_frequencies
        from ..ingest.kmers import get_kmers
        from ..train.checkpoint import fsw_ks

        input_dir = req["input_dir"]
        output_dir = req["output_dir"]
        os.makedirs(output_dir, exist_ok=True)
        cancel = self._cancel_flag()
        get_frequencies(
            input_dir, output_dir, k=req.get("k", self.args.k), threads=self.args.p,
            pseudocount=self.args.pseudocount, device=self.device, cancel=cancel,
        )
        for fk in fsw_ks(self.args.distance_model):
            get_kmers(input_dir, output_dir, k=fk, threads=self.args.p, device=self.device,
                      cancel=cancel)
        return self._classify_and_query(output_dir, output_dir, req.get("remap"))

    def handle_place_features(self, req: dict) -> dict:
        """Placement of extracted features: classify + query only."""
        return self._classify_and_query(
            req["features_dir"], req["output_dir"], req.get("remap")
        )

    def _classify_and_query(
        self, features_dir: str, output_dir: str, remap: str | None = None
    ) -> dict:
        from ..utils import phases
        from .classify import classify_func
        from .query import query_func

        files = sorted(glob.glob(os.path.join(features_dir, "*.kf")))
        if not files:
            raise FileNotFoundError(f"no .kf feature files in {features_dir}")
        os.makedirs(output_dir, exist_ok=True)
        cancel = self._cancel_flag()
        t0 = time.time()
        with phases.collect() as ph:
            classes_out = classify_func(
                features_dir, files, self.args.classifier_model, self.args.cl_seed,
                output_dir, device=self.device, cancel=cancel,
            )
            written = query_func(
                features_dir, files, self.args.distance_model, output_dir,
                self.args.di_seed, output_dir, remap_path=remap, device=self.device,
                cancel=cancel,
            )
        dt = time.time() - t0
        return {
            "ok": True,
            "queries": len(files),
            "seconds": round(dt, 3),
            "outputs": [classes_out] + written,
            "phases_ms": {
                k: round(1e3 * v, 1)
                for k, v in sorted(ph.items())
                if k != "dispatches"
            },
            "dispatches": int(ph.get("dispatches", 0)),
        }

    # -- loop ----------------------------------------------------------------

    def _call_handler(self, handler, req: dict) -> dict:
        """Run one handler, deadlined when request_timeout_s is set.

        The worker is a daemon thread: a handler wedged inside a device call
        is abandoned, never joined, after its request's cancel flag is set;
        the loop answers with an error and moves on. Exceptions raised by the
        handler propagate to the loop's per-request handler.

        warm gets its own (longer) deadline, so a placement-scale
        -request_timeout does not read a healthy warm as wedged
        (KF2VEC_SERVE_WARM_TIMEOUT_S, default 900, floor'd by the request
        timeout)."""
        timeout_s = self.request_timeout_s
        if timeout_s and handler == self.handle_warm:
            timeout_s = max(
                timeout_s,
                float(os.environ.get("KF2VEC_SERVE_WARM_TIMEOUT_S", "900") or 0),
            )
        if not timeout_s:
            return handler(req)
        box = {}
        done = threading.Event()
        cancel = CancelFlag()

        def target():
            self._local.cancel = cancel
            try:
                box["resp"] = handler(req)
            except BaseException as e:  # noqa: BLE001 — re-raised in the loop
                box["err"] = e
            finally:
                done.set()

        t = threading.Thread(target=target, daemon=True, name="serve-request")
        t.start()
        if not done.wait(timeout_s):
            cancel.cancel()  # before the reply: the worker writes nothing after it
            self.timeouts += 1
            return {
                "ok": False,
                "timeout": True,
                "error": (
                    f"request exceeded {timeout_s:g}s watchdog "
                    "(device stalled?); daemon still serving"
                ),
            }
        if "err" in box:
            raise box["err"]
        return box["resp"]

    def serve(self, stdin=None, stdout=None) -> int:
        stdin = stdin if stdin is not None else sys.stdin
        out = stdout if stdout is not None else sys.stdout
        handlers = {
            "ping": self.handle_ping,
            "stats": self.handle_stats,
            "warm": self.handle_warm,
            "place": self.handle_place,
            "place_features": self.handle_place_features,
        }

        def respond(obj: dict) -> None:
            out.write(json.dumps(obj) + "\n")
            out.flush()

        n_models = len(
            glob.glob(os.path.join(self.args.distance_model, "model_subtree_*.ckpt"))
        )
        respond(
            {
                "ok": True,
                "event": "ready",
                "subtree_models": n_models,
                "classifier_model": self.args.classifier_model,
                "distance_model": self.args.distance_model,
            }
        )
        # stages print operator logs: keep stdout pure protocol for the
        # loop's LIFETIME rather than per request. A redirect per request
        # would be unsafe under the watchdog: an abandoned worker leaving
        # its context later could put sys.stdout back mid-request; only
        # this thread ever restores it.
        old_stdout = sys.stdout
        sys.stdout = sys.stderr
        try:
            for line in stdin:
                line = line.strip()
                if not line:
                    continue
                try:
                    req = json.loads(line)
                    cmd = req.get("cmd")
                    if cmd == "quit":
                        respond({"ok": True, "bye": True})
                        break
                    handler = handlers.get(cmd)
                    if handler is None:
                        respond(
                            {
                                "ok": False,
                                "error": f"unknown cmd {cmd!r}",
                                "commands": sorted(handlers) + ["quit"],
                            }
                        )
                        continue
                    resp = self._call_handler(handler, req)
                    self.requests += 1
                    respond(resp)
                except (Exception, SystemExit) as e:  # noqa: BLE001 — the
                    # daemon must keep serving; stage code may sys.exit on
                    # bad input (reference-compatible CLI behavior)
                    respond({"ok": False, "error": f"{type(e).__name__}: {e}"})
        finally:
            sys.stdout = old_stdout
        return 0


def _exit_daemon(daemon: ServeDaemon, rc: int) -> None:
    """After a watchdog timeout an abandoned worker may still sit inside a
    wedged device call, and interpreter shutdown could then hang or abort
    in the runtime's teardown. The protocol stream is complete at this
    point, so leave via os._exit instead."""
    if daemon.timeouts:
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(rc)
