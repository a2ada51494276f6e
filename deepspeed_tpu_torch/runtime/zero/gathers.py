"""ZeRO stage 3's implicit gathers: each layer's parameters whole just
before the layer runs, freed after it, and gathered again for its backward.

At stage 3 the compute-dtype parameters of the sharded leaves hold only
this rank's shard at rest (``ZeroPartition.segment_views`` of one
segment). The implicit path (the scheduled int8 plan disarmed, or
``stage3_scheduled_gathers: false``) gathers them block by block, densely
in the compute dtype (one ``all_gather_into_tensor`` per block, counted
as ``param_ag`` for each of its leaves). A block is one layer of the
model (the parameters under one numbered module, ``h.3`` or
``bert.encoder.layer.3``; leaves that span several layers join them into
one block), and the parameters under no numbered module (embeddings,
the final LayerNorm, heads) form one pinned block, live for the whole
forward and the whole backward.

- Forward: a pre-hook on each module that holds a sharded parameter
  gathers its block when the module is called and frees the block that
  ran before it.
- The autograd graph holds no gathered weight: a saved-tensor hook keeps
  a weight, or a view of one, as its parameter's index and the view's
  geometry, and the backward's first use of a block's weight gathers the
  block again and frees the one after it in the forward order. A remat
  recompute calls the modules, so their pre-hooks are that gather.
So at most one layer and the pinned block are whole at once, and every
block is gathered twice per micro step: the count the JAX report prices
for the implicit path (``implicit_param_gathers_per_step``, 2 x gas).
"""
import contextlib
import re

import torch

_LAYER = re.compile(r"^(.*?\.\d+)(\.|$)")


def layer_key(name):
    """The numbered module a parameter name lies under (``h.3`` for
    ``h.3.attn.c_attn.weight``), or None."""
    m = _LAYER.match(name)
    return m.group(1) if m else None


class BlockGathers:
    """The implicit gathers of one engine's sharded parameters.

    ``params`` / ``param_names``: the engine's parameter list;
    ``partition``: its ZeroPartition; ``seg``: the flat segment of this
    rank's shards at rest (``rest``: the views of it, one per sharded
    parameter, in ``partition.sharded_idx`` order); ``group``: the data
    group the gathers run over."""

    def __init__(self, module, param_names, params, partition, seg, rest,
                 group):
        self.params, self.part, self.group = params, partition, group
        self.rest = dict(zip(partition.sharded_idx, rest))
        offset, at = {}, 0
        for i, v in zip(partition.sharded_idx, rest):
            offset[i] = at
            at += v.numel()
        self._seg, self._offset = seg, offset
        # blocks: by layer, merged where a leaf spans several
        key = {i: layer_key(param_names[i]) for i in partition.sharded_idx}
        parent = {k: k for k in key.values()}

        def find(k):
            while parent[k] != k:
                k = parent[k]
            return k
        sharded_leaves = [leaf for leaf in partition.leaves
                          if any(partition.sharded[i] for i in leaf.params)]
        for leaf in sharded_leaves:
            ks = [find(key[i]) for i in leaf.params if i in key]
            for k in ks[1:]:
                parent[k] = ks[0]
        order = []
        for i in partition.sharded_idx:
            k = find(key[i])
            if k not in order:
                order.append(k)
        self.blocks = [[i for i in partition.sharded_idx if find(key[i]) == k]
                       for k in order]
        self.block_of = {i: b for b, idx in enumerate(self.blocks)
                         for i in idx}
        self.pinned = order.index(None) if None in order else None
        self.leaves = [[] for _ in self.blocks]
        for leaf in sharded_leaves:
            self.leaves[self.block_of[leaf.params[0]]].append(
                (leaf.name, leaf.elements))
        self.live = set()
        self.on = False
        self.counted = False
        self._ptrs = {}             # a gathered weight's storage -> index
        by_id = {id(p): i for i, p in enumerate(params)}
        for mod in module.modules():
            mine = sorted({self.block_of[by_id[id(p)]]
                           for p in mod.parameters(recurse=False)
                           if by_id.get(id(p)) in self.block_of})
            if mine:
                mod.register_forward_pre_hook(self._pre_hook(mine))

    def _pre_hook(self, blocks):
        def hook(module, args):
            for b in blocks:
                self.touch(b)
        return hook

    # -- the gathers ---------------------------------------------------
    @torch.no_grad()
    def gather(self, b, counted):
        """Block ``b``'s parameters whole: this rank's shards (a slice of
        the segment where they lie side by side) gathered from every rank
        in the compute dtype into new tensors, set as the parameters' data
        (a write through a parameter would bump the version its saved uses
        check)."""
        part, idx = self.part, self.blocks[b]
        pos = [self._offset[i] for i in idx]
        sizes = [self.rest[i].numel() for i in idx]
        if all(p + s == q for p, s, q in zip(pos, sizes, pos[1:])):
            send = self._seg[pos[0]:pos[0] + sum(sizes)]
        else:
            send = torch.cat([self.rest[i].reshape(-1) for i in idx])
        w = self.group.size
        recv = torch.empty(w * send.numel(), dtype=send.dtype,
                           device=send.device)
        self.group.all_gather(recv, send,
                              leaves=self.leaves[b] if counted else ())
        full = {i: torch.empty(part.shapes[i], dtype=send.dtype,
                               device=send.device) for i in idx}
        dst, src = [], []
        for r, chunk in enumerate(recv.chunk(w)):
            at = 0
            for i in idx:
                view = part.narrow(full[i], i, r)
                n = view.numel()
                if n:
                    dst.append(view)
                    src.append(chunk[at:at + n].view(view.shape))
                at += n
        torch._foreach_copy_(dst, src)
        for i in idx:
            self.params[i].data = full[i]
            self._ptrs[full[i].untyped_storage().data_ptr()] = i
        self.live.add(b)

    def free(self, b):
        """Block ``b``'s parameters back to their shards at rest."""
        for i in self.blocks[b]:
            self._ptrs.pop(self.params[i].untyped_storage().data_ptr(), None)
            self.params[i].data = self.rest[i]
        self.live.discard(b)

    def touch(self, b):
        """Block ``b`` is about to be used: gather it unless it is whole,
        and free the other layers' (not the pinned block)."""
        if not self.on or b in self.live:
            return
        if b != self.pinned:
            for other in [o for o in self.live if o != self.pinned]:
                self.free(other)
        self.gather(b, self.counted)

    def release(self):
        for b in list(self.live):
            self.free(b)

    # -- the regions ----------------------------------------------------
    @contextlib.contextmanager
    def _region(self, counted):
        self.on, self.counted = True, counted
        try:
            if self.pinned is not None:
                self.touch(self.pinned)
            yield
        finally:
            self.release()
            self.on = False

    @contextlib.contextmanager
    def forward(self, counted=True):
        """A forward: the pinned block whole throughout, each layer's
        gathered when its modules are called; the graph saves weights as
        references to their parameters. Everything is freed at the end."""
        with self._region(counted), \
                torch.autograd.graph.saved_tensors_hooks(self._pack,
                                                         self._unpack):
            yield

    def backward(self):
        """A backward of a graph ``forward`` built: the pinned block whole
        throughout, each layer's gathered at its first use."""
        return self._region(True)

    def _pack(self, t):
        if self._ptrs and t.layout == torch.strided:
            i = self._ptrs.get(t.untyped_storage().data_ptr())
            if i is not None:
                return (i, t.size(), t.stride(), t.storage_offset())
        return t

    def _unpack(self, packed):
        if not isinstance(packed, tuple):
            return packed
        i, size, stride, offset = packed
        if not self.on:
            raise RuntimeError(
                "a ZeRO stage-3 weight was read by a backward outside the "
                "engine's backward(): run the backward through the engine")
        self.touch(self.block_of[i])
        return self.params[i].data.as_strided(size, stride, offset)
