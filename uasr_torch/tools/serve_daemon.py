"""Dynamic-batching online serving daemon (counterpart of
``uasr.tools.serve_daemon``).

The B slots of ONE batched ``StreamingRecognizer`` are multiplexed across
live TCP clients that connect, stream audio and disconnect independently.
Every engine tick is one ``masked_step`` however many clients are active,
so serving cost scales with the chunk rate, not the client count; slots
are reset in place (``reset_slots``) and reused at once.

Wire protocol (one TCP connection per utterance stream), the JAX
package's unchanged:

  client -> server: binary frames  [1-byte opcode][4-byte LE length][payload]
      0x01 START  payload: UTF-8 JSON options (currently ``{}``)
      0x02 AUDIO  payload: float32 LE PCM samples at the recipe's
                  sample rate (any size; the server re-chunks)
      0x03 END    payload: empty; flush and finalize the stream
  server -> client: JSON lines (UTF-8, one object per line)
      {"event": "ready", "chunk_samples": N}
      {"event": "partial", "ids": [...]}     after each decoded chunk
      {"event": "final", "ids": [...]}       complete transcript
      {"event": "busy"}                      no free slot (then closes)

Exactness: a stream's final transcript equals the offline decode of its
full utterance (greedy partials + tail flush, or the carried exact beam
when ``ctc.use_beam``): the daemon pads the tail to a chunk multiple and
stamps the true sample count, the offline path's padding + length
masking. Any encoder ``StreamingRecognizer`` streams is served: ``cnn``
(window replay) and the causal recurrent ``uni_gru`` and ``lc_bigru``
(carried state; ``lc_bigru``'s finish flushes its layer lag).

  python -m uasr_torch.tools.serve_daemon -c recipe.yaml [--port 8790] \
      [--batch 8] [--chunk-frames 64] [--device cuda|cpu]

Sockets time out (``CLIENT_TIMEOUT_S``): a silent client is dropped and
its slot freed; the client side gives up rather than hang.
"""

from __future__ import annotations

import argparse
import json
import queue
import socket
import socketserver
import struct
import sys
import threading
import time

import numpy as np

CLIENT_TIMEOUT_S = 120.0


OP_START, OP_AUDIO, OP_END = 1, 2, 3


class StreamSession:
    """Book-keeping for one live client stream pinned to a slot."""

    def __init__(self, slot: int):
        self.slot = slot
        self.buffer = np.zeros((0,), np.float32)  # samples not yet chunked
        self.total_samples = 0
        self.ending = False
        self.stamped = False
        self.dead = False  # client vanished: discard, don't finalize
        self.partials: list[int] = []
        self.events: "queue.Queue[tuple[str, list[int]]]" = queue.Queue()


class TickStats:
    """What the engine loop did, on the host clock: ticks dispatched, the
    chunks they carried and the slots live at each, and the seconds spent
    idle (nothing to do), in the batching window, and on ticks (dispatch,
    readback of the tick before, finals)."""

    def __init__(self):
        self.ticks = self.chunks = self.live = self.lingers = 0
        self.idle_s = self.linger_s = self.busy_s = 0.0


class ServingEngine:
    """Owns the batched recognizer state; one thread does every device
    call (tick loop), sessions communicate through flags/queues.
    ``stats`` (a ``TickStats``) counts what the loop does; replace it with
    a fresh one to start a new count."""

    def __init__(self, rec, linger_s: float = 0.002):
        self.rec = rec
        self.batch = None  # set by state init below
        self.state = None
        self.chunk_samples = rec.chunk * rec.cfg.frontend.frame_shift
        self.linger_s = linger_s
        self._lock = threading.Condition()
        self._free: list[int] = []
        self._live: dict[int, StreamSession] = {}
        self._running = True
        self.stats = TickStats()
        self._thread = threading.Thread(
            target=self._loop, name="uasr-serve-engine", daemon=True
        )

    def start(self, batch: int):
        self.batch = batch
        self.state = self.rec.init(batch)
        self._free = list(range(batch))
        self._thread.start()

    def stop(self):
        with self._lock:
            self._running = False
            self._lock.notify_all()
        self._thread.join(timeout=10)

    # ---- session API (called from connection threads)

    def open(self) -> StreamSession | None:
        with self._lock:
            if not self._free:
                return None
            slot = self._free.pop()
            sess = StreamSession(slot)
            self._live[slot] = sess
            return sess

    def feed(self, sess: StreamSession, samples: np.ndarray):
        with self._lock:
            sess.buffer = np.concatenate([sess.buffer, samples])
            sess.total_samples += len(samples)
            self._lock.notify_all()

    def end(self, sess: StreamSession, dead: bool = False):
        with self._lock:
            sess.ending = True
            sess.dead = sess.dead or dead
            self._lock.notify_all()

    # ---- engine loop (all device work happens here)

    def _collect(self, taken=frozenset()):
        """Under the lock: pull at most one chunk per ready session,
        plus the sessions to stamp/finalize this tick. Sessions in
        ``taken`` (slots that already hold a chunk this tick) are left as
        they are: a second chunk pulled for one would be lost, and a slot
        cannot step and finish in one tick."""
        S = self.chunk_samples
        chunks, stamp, final = [], [], []
        for slot, sess in list(self._live.items()):
            if slot in taken:
                continue
            if sess.dead:
                final.append(sess)
                continue
            if sess.ending and not sess.stamped:
                stamp.append(sess)
            if len(sess.buffer) >= S:
                chunks.append((sess, sess.buffer[:S]))
                sess.buffer = sess.buffer[S:]
            elif sess.ending:
                if len(sess.buffer) > 0:  # zero-pad the tail chunk
                    pad = np.zeros((S,), np.float32)
                    pad[: len(sess.buffer)] = sess.buffer
                    sess.buffer = sess.buffer[:0]
                    chunks.append((sess, pad))
                else:
                    final.append(sess)
        return chunks, stamp, final

    def _drain(self, pending):
        """Materialize a dispatched tick's packed output (the only
        device->host transfer of the steady-state loop) and emit
        partial events."""
        if pending is None:
            return
        chunk_sessions, out = pending
        out = out.cpu().numpy()  # [B, K+1]; column K = emitted count
        for sess in chunk_sessions:
            toks = out[sess.slot, : out[sess.slot, -1]].tolist()
            if toks:
                sess.partials.extend(toks)
                sess.events.put(("partial", toks))

    def _loop(self):
        """Engine tick. Throughput-critical structure (every
        device->host copy waits for the device to finish the work
        queued before it):

          - length stamping rides the SAME call as the chunk step
            (masked_step stamp args), and finish+reset are one call
            (finish_and_reset) — a stream's whole lifecycle costs
            chunk-ticks + 1 extra call, not +3;
          - readback is PIPELINED one tick behind dispatch: tick k's
            ids/counts are pulled while tick k+1's step is already in
            flight, so the transfer latency hides behind compute
            (partials arrive one tick late; finals drain everything)."""
        S = self.chunk_samples
        B = self.batch
        pending = None  # last tick's (chunk_sessions, ids_dev, counts_dev)
        while True:
            t_wait = time.perf_counter()
            with self._lock:
                chunks, stamp, final = self._collect()
                while (
                    self._running
                    and not chunks and not stamp and not final
                ):
                    if pending is not None:
                        break  # drain the in-flight tick before sleeping
                    self._lock.wait(timeout=0.1)
                    chunks, stamp, final = self._collect()
                if not self._running:
                    self._drain(pending)
                    return
            stats = self.stats
            t_linger = time.perf_counter()
            stats.idle_s += t_linger - t_wait
            if self.linger_s and chunks and len(chunks) < len(self._live):
                # tiny batching window: let co-arriving chunks join
                threading.Event().wait(self.linger_s)
                with self._lock:
                    more, stamp2, final2 = self._collect({s.slot for s, _ in chunks})
                    chunks += more
                    stamp += [s for s in stamp2 if s not in stamp]
                    final += [s for s in final2 if s not in final]
                stats.lingers += 1
            t_tick = time.perf_counter()
            stats.linger_s += t_tick - t_linger

            reset = None
            if final:
                reset = np.zeros((B,), bool)
                for sess in final:
                    reset[sess.slot] = True

            dispatched = None
            fout = None
            if chunks or stamp:
                mask = np.zeros((B,), bool)
                audio = np.zeros((B, S), np.float32)
                for sess, chunk in chunks:
                    mask[sess.slot] = True
                    audio[sess.slot] = chunk
                smask = np.zeros((B,), bool)
                samples = np.zeros((B,), np.int64)
                for sess in stamp:
                    smask[sess.slot] = True
                    samples[sess.slot] = sess.total_samples
                    sess.stamped = True
                if final:
                    # finalize tick: the step AND the finish+reset ride
                    # ONE dispatch (finalizing slots never carry a
                    # chunk this tick; per-slot state is independent) —
                    # saves a full round trip per utterance end
                    self.state, out, fout = self.rec.masked_step_and_finish(
                        self.state, audio, mask, reset, smask, samples
                    )
                    dispatched = ([s for s, _ in chunks], out)
                else:
                    self.state, out = self.rec.masked_step(
                        self.state, audio, mask, smask, samples,
                        packed=True,
                    )
                    dispatched = ([s for s, _ in chunks], out)
                stats.ticks += 1
                stats.chunks += len(chunks)
                stats.live += len(self._live)

            # previous tick's outputs are ready (or nearly); pull them
            # while this tick's step runs on device
            self._drain(pending)
            pending = dispatched

            if final:
                # finals must observe every emitted partial: drain the
                # in-flight tick too (finalizing sessions have no chunk
                # in it, but their last chunk may be the one in flight)
                self._drain(pending)
                pending = None
                need_finish = [s for s in final if not s.dead]
                if fout is None:
                    self.state, fout = self.rec.finish_and_reset(
                        self.state, reset, packed=True
                    )
                if need_finish:
                    fout = fout.cpu().numpy()  # [B, K+1]; col K = count
                for sess in final:
                    if not sess.dead:
                        tail = fout[
                            sess.slot, : fout[sess.slot, -1]
                        ].tolist()
                        if self.rec.use_beam:
                            full = tail  # beam finish returns everything
                        else:
                            full = sess.partials + tail
                        sess.events.put(("final", full))
                with self._lock:
                    for sess in final:
                        del self._live[sess.slot]
                        self._free.append(sess.slot)
            stats.busy_s += time.perf_counter() - t_tick


# ---------------------------------------------------------------------------
# TCP layer


def _read_frame(rfile):
    """(opcode, payload), or (None, None) when the client vanished or
    stayed silent past the handler's timeout."""
    try:
        hdr = rfile.read(5)
        if len(hdr) < 5:
            return None, None
        op = hdr[0]
        (n,) = struct.unpack("<I", hdr[1:5])
        payload = rfile.read(n) if n else b""
    except OSError:  # timeout or reset
        return None, None
    if len(payload) < n:
        return None, None
    return op, payload


def _send_json(wfile, obj) -> bool:
    try:
        wfile.write((json.dumps(obj) + "\n").encode())
        wfile.flush()
        return True
    except (BrokenPipeError, ConnectionResetError, OSError):
        return False


class _Handler(socketserver.StreamRequestHandler):
    timeout = CLIENT_TIMEOUT_S  # an idle client is dropped, never waited on forever

    def handle(self):
        engine: ServingEngine = self.server.engine  # type: ignore[attr-defined]
        op, _ = _read_frame(self.rfile)
        if op != OP_START:
            return
        sess = engine.open()
        if sess is None:
            _send_json(self.wfile, {"event": "busy"})
            return
        _send_json(
            self.wfile,
            {"event": "ready", "chunk_samples": engine.chunk_samples},
        )

        stop = threading.Event()

        def sender():
            while not stop.is_set():
                try:
                    kind, ids = sess.events.get(timeout=0.1)
                except queue.Empty:
                    continue
                ok = _send_json(
                    self.wfile,
                    {"event": kind, "ids": [int(i) for i in ids]},
                )
                if kind == "final" or not ok:
                    stop.set()
                    return

        tx = threading.Thread(target=sender, daemon=True)
        tx.start()
        clean = False
        try:
            while True:
                op, payload = _read_frame(self.rfile)
                if op is None:
                    break  # client vanished
                if op == OP_AUDIO:
                    engine.feed(
                        sess, np.frombuffer(payload, np.float32).copy()
                    )
                elif op == OP_END:
                    clean = True
                    engine.end(sess)
                    break
        finally:
            if not clean:
                engine.end(sess, dead=True)
                stop.set()
            tx.join(timeout=CLIENT_TIMEOUT_S)
            stop.set()


class StreamServer(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True

    def __init__(self, addr, engine: ServingEngine):
        super().__init__(addr, _Handler)
        self.engine = engine


def create_server(cfg, model, host="127.0.0.1", port=0, batch=8,
                  chunk_frames=None, linger_s=0.002, device="cuda"):
    """Build (server, engine) ready to serve ``model`` (an encoder of
    ``uasr_torch.models`` holding its weights); the caller runs
    server.serve_forever() (tests run it in a thread)."""
    from uasr_torch.serve import StreamingRecognizer

    rec = StreamingRecognizer(cfg, model, chunk_frames=chunk_frames, device=device)
    engine = ServingEngine(rec, linger_s=linger_s)
    engine.start(batch)
    server = StreamServer((host, port), engine)
    return server, engine


# ---------------------------------------------------------------------------
# client (used by tests and as a library for service consumers)


class StreamClient:
    """Minimal blocking client for the daemon protocol."""

    def __init__(self, host: str, port: int, timeout: float = CLIENT_TIMEOUT_S):
        self.sock = socket.create_connection((host, port), timeout=timeout)
        self.rfile = self.sock.makefile("rb")
        self.partials: list[int] = []

    def _frame(self, op: int, payload: bytes = b""):
        self.sock.sendall(bytes([op]) + struct.pack("<I", len(payload))
                          + payload)

    def _read_event(self):
        line = self.rfile.readline()
        if not line:
            raise ConnectionError("server closed the connection")
        return json.loads(line)

    def start(self) -> int:
        """Returns the server's chunk size in samples."""
        self._frame(OP_START, b"{}")
        ev = self._read_event()
        if ev["event"] == "busy":
            raise RuntimeError("server busy: no free stream slot")
        return int(ev["chunk_samples"])

    def send_audio(self, samples: np.ndarray):
        self._frame(
            OP_AUDIO, np.ascontiguousarray(samples, np.float32).tobytes()
        )

    def finish(self) -> list[int]:
        """Send END; drain partials; return the final transcript ids."""
        self._frame(OP_END)
        while True:
            ev = self._read_event()
            if ev["event"] == "partial":
                self.partials.extend(ev["ids"])
            elif ev["event"] == "final":
                self.close()
                return ev["ids"]

    def close(self):
        try:
            self.sock.close()
        except OSError:
            pass


# ---------------------------------------------------------------------------
# CLI


def main(argv=None):
    ap = argparse.ArgumentParser("uasr_torch.tools.serve_daemon",
                                 description="dynamic-batching streaming ASR daemon")
    ap.add_argument("-c", "--config", required=True)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8790)
    ap.add_argument("--batch", type=int, default=8,
                    help="recognizer slots = max concurrent streams")
    ap.add_argument("--chunk-frames", type=int, default=None)
    ap.add_argument("--set", action="append", default=[], metavar="KEY=VALUE")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels; raises without a card) or cpu (plain versions)")
    args = ap.parse_args(argv)

    from uasr_torch import resolve_device
    from uasr_torch.cli import apply_overrides, restore_trainer
    from uasr_torch.config import load_config

    cfg = load_config(args.config)
    apply_overrides(cfg, args.set)
    if cfg.vocab_size is None:
        from uasr_torch.vocab import load_vocab

        if not cfg.data.vocab_path:
            raise SystemExit("recipe needs vocab_size or data.vocab_path")
        cfg = cfg.replace(vocab_size=len(load_vocab(cfg.data.vocab_path)))
    device = resolve_device(args.device)
    trainer, step = restore_trainer(cfg, device)
    server, engine = create_server(
        cfg, trainer.model, host=args.host, port=args.port, batch=args.batch,
        chunk_frames=args.chunk_frames, device=device,
    )
    host, port = server.server_address[:2]
    print(f"serve: step {step}, {args.batch} slots, chunk {engine.chunk_samples} samples, "
          f"listening on {host}:{port}", file=sys.stderr, flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()
        server.server_close()
        engine.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
