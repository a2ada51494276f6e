"""Worker main for :class:`ProcessTransport` (transport.py).

Spawned once per peer rank with ``DSTPU_TR_{RANK,WORLD,JOURNAL}`` set.
Port of deepspeed_tpu/runtime/resilience/transport_worker.py (a copy).
STDLIB ONLY: importing the package (and through it torch) would make
every spawn pay a multi-second import and tie the worker to the parent's
device runtime; a peer is a cheap OS process that can be SIGKILLed
mid-protocol.

Protocol: JSON lines.  stdin commands ->

- ``{"t": "step", "step": N}``     -> ``{"t": "beat", "rank": r, "step": N}``
- ``{"t": "submit", "seq": S, "payload": P}``
                                   -> ``{"t": "result", "seq": S,
                                         "rank": r, "payload": <op result>}``
- ``{"t": "vote", "step": N, "dead": [...]}``
                                   -> ``{"t": "vote_ack", "rank": r,
                                         "step": N, "agree": true}``
  (a live worker always agrees a set it is NOT in is dead: its own
  liveness is exactly what answering proves; a dead worker cannot ack,
  which is what makes the vote mean something)
- ``{"t": "exit"}``                -> clean exit 0

The op table mirrors ``transport.execute_op``, a hand-kept stdlib
copy that must give identical results.
"""
import base64
import hashlib
import json
import os
import sys
import time

RANK = int(os.environ.get("DSTPU_TR_RANK", "0"))
JOURNAL = os.environ.get("DSTPU_TR_JOURNAL") or None

_state = {"journal_path": JOURNAL, "journal_count": 0, "blobs": {}}


def _execute_op(payload):
    op = payload.get("op")
    if op == "echo":
        return dict(payload)
    if op == "sum":
        return {"op": "sum", "value": sum(payload.get("xs") or [])}
    if op == "journal":
        path = _state["journal_path"]
        if not path:
            return {"op": "journal", "error": "no journal armed"}
        # append-only fsynced journal, NOT a checkpoint (mirrors
        # transport.execute_op — see its suppression note)
        with open(path, "a") as f:  # graftlint: disable=raw-ckpt-write
            f.write(json.dumps(payload.get("record")) + "\n")
            f.flush()
            os.fsync(f.fileno())
        _state["journal_count"] += 1
        return {"op": "journal", "count": _state["journal_count"]}
    if op == "sleep":
        time.sleep(float(payload.get("seconds", 0.0)))
        return {"op": "sleep"}
    if op == "handoff":
        blob = base64.b64decode(payload.get("blob", ""))
        _state["blobs"][payload.get("key")] = blob
        return {"key": payload.get("key"),
                "sha256": hashlib.sha256(blob).hexdigest(),
                "nbytes": len(blob)}
    if op == "crash":
        os._exit(3)
    return {"op": op, "error": "unknown op"}


def _emit(msg):
    sys.stdout.write(json.dumps(msg) + "\n")
    sys.stdout.flush()


def main():
    for line in sys.stdin:
        try:
            msg = json.loads(line)
        except ValueError:
            continue
        t = msg.get("t")
        if t == "step":
            _emit({"t": "beat", "rank": RANK,
                   "step": int(msg.get("step", 0))})
        elif t == "submit":
            _emit({"t": "result", "seq": int(msg.get("seq", -1)),
                   "rank": RANK,
                   "payload": _execute_op(msg.get("payload") or {})})
        elif t == "vote":
            dead = [int(r) for r in (msg.get("dead") or [])]
            _emit({"t": "vote_ack", "rank": RANK,
                   "step": int(msg.get("step", -1)),
                   "agree": RANK not in dead})
        elif t == "exit":
            return 0
    return 0                    # parent closed stdin: clean shutdown


if __name__ == "__main__":
    sys.exit(main())
