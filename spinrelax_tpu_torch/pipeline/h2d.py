"""Host-to-card copies of the streamed C(t) stage's groups
(:func:`pipeline.stages.stage_ct_streamed`).

On a card a group's observables go through two pinned staging slots and a
copy stream (:class:`PinnedCopier`): the host copies the decoder's
pageable arrays into a slot on several threads (torch's ``copy_``),
issues the slot's copies to the card on the copy stream and makes the
compute stream wait for them, so the copy of group k + 1 runs while the
card computes group k.  Elsewhere (the CPU) a group is the arrays
themselves (:func:`pageable`).
"""

from __future__ import annotations

import contextlib
import functools
import os

import numpy as np
import torch

from ..utils import profiling

SLOT_BYTES = 256 << 20  # a slot's most bytes: a larger group fills both in turns
PIECE_BYTES = 32 << 20  # the most bytes staged before their copy to the card is issued
_ALIGN = 64  # byte alignment of each array's piece in a slot


def _aligned(n: int) -> int:
    return -(-n // _ALIGN) * _ALIGN


def pageable(arrays, dtype, dev):
    """The numpy ``arrays`` as tensors on ``dev`` in ``dtype``, each by a
    plain copy (none where it already is what is asked for: on the CPU in
    its own dtype, the array's memory itself)."""
    return [torch.from_numpy(a).to(device=dev, dtype=dtype) for a in arrays]


def plan(counts, item: int, slot_bytes: int, piece_bytes: int = PIECE_BYTES):
    """How arrays of ``counts`` elements of ``item`` bytes each go through
    slots of ``slot_bytes`` (at least ``_ALIGN``): a list of slot fills,
    each a list of pieces ``(array, lo, hi, offset)``, elements [lo, hi)
    of the array at byte ``offset`` of the slot, of at most
    ``piece_bytes`` (at least ``item``); the arrays in order, each piece
    at a 64-byte boundary, a fill started only when the last one has no
    room."""
    fills, fill, used = [], [], 0
    for i, n in enumerate(counts):
        lo = 0
        while lo < n:
            room = (slot_bytes - used) // item
            if room == 0:
                fills.append(fill)
                fill, used = [], 0
                continue
            hi = min(n, lo + room, lo + piece_bytes // item)
            fill.append((i, lo, hi, used))
            used = _aligned(used + (hi - lo) * item)
            lo = hi
    fills.append(fill)
    return fills


def host_threads(mesh) -> int:
    """Threads of a slot's host copy: the cores of this process's affinity,
    shared among the ranks of a mesh that run on this host (torchrun's
    ``LOCAL_WORLD_SIZE``)."""
    cores = len(os.sched_getaffinity(0))
    local = int(os.environ.get("LOCAL_WORLD_SIZE") or 1) if mesh is not None else 1
    return max(1, cores // max(1, local))


@functools.cache
def copy_stream(dev: torch.device) -> torch.cuda.Stream:
    """The one copy stream of card ``dev`` for every stage of the process:
    the caching allocator keeps freed device blocks per stream, so a new
    stream each stage would find none and allocate (and wait) anew."""
    return torch.cuda.Stream(dev)


@contextlib.contextmanager
def intra_op_threads(n: int):
    """torch's intra-op threads set to ``n`` inside the block, restored
    after it."""
    was = torch.get_num_threads()
    if was == n:
        yield
        return
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(was)


class PinnedCopier:
    """``copier(arrays, dtype)`` -> the arrays as tensors on the card, in
    ``dtype``, through two pinned slots on a copy stream.

    The slots are allocated at the first call, each the size of that
    group's arrays (``SLOT_BYTES`` at most), from torch's caching host
    allocator, so a later stage reuses the same blocks.  A call fills the
    next slot with the arrays, one after another (a group larger than a
    slot fills both in turns), in pieces of ``PIECE_BYTES`` at most, and
    issues each piece's copy to the card on the copy stream with
    ``non_blocking=True`` as soon as it is staged, so the card copies one
    piece while the host stages the next.  It records the slot's event
    after the slot's last piece and makes the caller's current stream
    wait on the group's last event.  Before the host writes a slot it
    waits on that slot's last event (span ``stage_ct.h2d_slot_wait``):
    that is its only wait on the card.  The host copy has finished when
    a call returns, so the caller may reuse its arrays at once.  The
    device tensors are allocated on the copy stream and recorded on the
    caller's, so the allocator hands their memory to no new tensor before
    both streams are done with it.

    The host copies are torch's ``copy_`` on ``threads`` intra-op
    threads (a dtype change rounds as the pageable copy's does).  Counts
    the arrays' bytes in ``stage_ct.h2d_pinned_bytes``."""

    def __init__(self, dev, threads: int):
        self.dev = torch.device(dev)
        self.threads = threads
        if self.dev.index is None:
            self.dev = torch.device("cuda", torch.cuda.current_device())
        self.stream = copy_stream(self.dev)
        self.slots = None
        self.events = [None, None]
        self.turn = 1  # the slot last filled: the first call fills slot 0

    def _next_slot(self):
        self.turn ^= 1
        ev = self.events[self.turn]
        if ev is not None:
            with profiling.span("stage_ct.h2d_slot_wait"):
                ev.synchronize()
        return self.slots[self.turn]

    def __call__(self, arrays, dtype):
        arrays = [np.ascontiguousarray(a) for a in arrays]
        srcs = [torch.from_numpy(a).view(-1) for a in arrays]
        item = torch.empty((), dtype=dtype).element_size()
        if self.slots is None:
            size = max(_ALIGN, min(SLOT_BYTES, sum(_aligned(a.numel() * item) for a in srcs)))
            self.slots = [torch.empty(size, dtype=torch.uint8, pin_memory=True)
                          for _ in range(2)]
        with torch.cuda.stream(self.stream):
            outs = [torch.empty(a.shape, dtype=dtype, device=self.dev) for a in arrays]
        with intra_op_threads(self.threads):
            for fill in plan([a.numel() for a in srcs], item, self.slots[0].numel()):
                slot = self._next_slot()
                for i, lo, hi, off in fill:
                    piece = slot[off: off + (hi - lo) * item].view(dtype)
                    piece.copy_(srcs[i][lo:hi])
                    with torch.cuda.stream(self.stream):
                        outs[i].view(-1)[lo:hi].copy_(piece, non_blocking=True)
                self.events[self.turn] = self.stream.record_event()
        current = torch.cuda.current_stream(self.dev)
        current.wait_event(self.events[self.turn])
        for out in outs:
            out.record_stream(current)
        profiling.count("stage_ct.h2d_pinned_bytes", sum(a.nbytes for a in arrays))
        return outs


def copier(dev, mesh=None):
    """The stage's copy of a group, ``copy(arrays, dtype)`` -> tensors on
    ``dev``: a :class:`PinnedCopier` on a card, :func:`pageable` elsewhere."""
    dev = torch.device(dev)
    if dev.type == "cuda":
        return PinnedCopier(dev, host_threads(mesh))
    return functools.partial(pageable, dev=dev)
