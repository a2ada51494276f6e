"""The link between pipeline chunks: one seam, two layouts.

Named after the reference's deepspeed/runtime/pipe/p2p.py. The engine
(runtime/pipe/engine.py) runs the same instruction code in both layouts of
the ``pipe`` axis; only the link differs:

- ``LocalLink``: one process drives its whole pipe line on its own device
  (the JAX engine's single-controller layout). A Send hands the tensor to
  the destination chunk's FIFO queue; a Recv pops it. Nothing is copied.
- ``DistLink``: one process per stage. A Send is a ``torch.distributed``
  isend to the process of the destination chunk's stage, a Recv an irecv
  that the Recv waits for. Each edge (the boundary between global chunks
  q and q + 1) has a process group of its own for each direction, so a
  group carries messages one way only, in the order the sender posts
  them. Over NCCL the p2p ops of one communicator run in order on one
  stream, and a send completes only when its recv is posted: with one
  group for both directions, stage s posting *send act, recv grad* while
  stage s + 1 posts *send grad, recv act* would hang both. With a group
  per edge and direction the compiled streams, which are deadlock-free
  under unbounded asynchronous sends (the JAX interpreter's queues), stay
  so: a send never waits on the host, and each recv waits only for the
  matching send. A send's tensor is held until its work completes: each
  Send and Recv first drops the sends that have completed (a poll that
  never blocks the host or orders a stream; a gloo send reports
  completion only once waited for), and the end of the batch waits for
  the rest. ``peak_held_bytes`` is the most held at once in the batch.

Both record each payload's bytes per edge and kind (``edge_bytes``, the
first payload of each, as the JAX engine's ``_transfer`` records them for
``pipeline_report()``) and the bytes sent in the current batch
(``step_bytes``).
"""
from collections import deque

import torch
import torch.distributed as dist


class _Link:
    def __init__(self):
        self.edge_bytes = {}
        self.step_bytes = 0

    def begin_batch(self):
        self.step_bytes = 0

    def _note(self, tensor, edge, kind):
        nbytes = tensor.numel() * tensor.element_size()
        self.step_bytes += nbytes
        self.edge_bytes.setdefault(edge, {}).setdefault(kind, nbytes)


class LocalLink(_Link):
    """Queues inside one process: every chunk is this process's."""

    def __init__(self):
        super().__init__()
        self._queues = {}

    def _queue(self, chunk, kind):
        return self._queues.setdefault((chunk, kind), deque())

    def send(self, tensor, src, dst, kind):
        """``tensor`` from chunk ``src`` to chunk ``dst`` (``kind`` "act" or
        "grad"): appended to ``dst``'s queue."""
        self._note(tensor, min(src, dst), kind)
        self._queue(dst, kind).append(tensor)

    def ready(self, chunk, kind):
        return bool(self._queue(chunk, kind))

    def recv(self, chunk, kind, shape, dtype):
        return self._queue(chunk, kind).popleft()

    def finish_batch(self):
        assert not any(self._queues.values()), \
            "pipeline link: payloads left unreceived at the end of a batch"


class DistLink(_Link):
    """``torch.distributed`` p2p between the processes of neighbouring
    stages. ``groups[(edge, kind)]``: the two-rank group of this rank's
    data line for that edge and direction (utils/distributed.py
    ``pipe_groups``); ``owner_rank(chunk)``: the global rank holding a
    chunk."""

    def __init__(self, groups, owner_rank, device):
        super().__init__()
        self._groups = groups
        self._owner_rank = owner_rank
        self._device = device
        self._sends = []
        self.held_bytes = self.peak_held_bytes = 0

    def begin_batch(self):
        super().begin_batch()
        self.peak_held_bytes = self.held_bytes

    def _release_completed(self):
        held = [(w, t) for w, t in self._sends if not w.is_completed()]
        if len(held) < len(self._sends):
            self._sends = held
            self.held_bytes = sum(t.numel() * t.element_size()
                                  for _, t in held)

    def send(self, tensor, src, dst, kind):
        self._release_completed()
        edge = min(src, dst)
        self._note(tensor, edge, kind)
        tensor = tensor.contiguous()
        work = dist.isend(tensor, self._owner_rank(dst),
                          group=self._groups[(edge, kind)])
        # the tensor stays alive until its send completes
        self._sends.append((work, tensor))
        self.held_bytes += tensor.numel() * tensor.element_size()
        self.peak_held_bytes = max(self.peak_held_bytes, self.held_bytes)

    def ready(self, chunk, kind):
        return True

    def recv(self, chunk, kind, shape, dtype):
        self._release_completed()
        src = chunk - 1 if kind == "act" else chunk + 1
        buf = torch.empty(shape, dtype=dtype, device=self._device)
        dist.irecv(buf, self._owner_rank(src),
                   group=self._groups[(min(src, chunk), kind)]).wait()
        return buf

    def finish_batch(self):
        for work, _ in self._sends:
            work.wait()
        self._sends = []
        self.held_bytes = 0
