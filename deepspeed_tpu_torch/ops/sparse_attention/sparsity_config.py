"""Block-sparse attention layout generators.

A copy of deepspeed_tpu/ops/sparse_attention/sparsity_config.py (numpy and
the stdlib ``random`` only), kept here so that the port imports nothing of
the JAX package; every ``make_layout`` gives the same array as the JAX one
(BigBird and Variable draw from ``random``, so seed it before each call).

Reference behavior: deepspeed/ops/sparse_attention/sparsity_config.py:9-663
(Dense / Fixed / Variable / BigBird / BSLongformer patterns). Every config
emits an int {0,1} array of shape (num_heads, seq_len//block,
seq_len//block) where layout[h, i, j] == 1 means query block i attends to
key block j for head h. The layouts drive the block-sparse kernels
(block_sparse_kernel.py) through their lookup tables.
"""
import random

import numpy as np


class SparsityConfig:
    """Shared config: head count, block size, per-head layout switch
    (reference sparsity_config.py:9-62)."""

    def __init__(self, num_heads, block=16, different_layout_per_head=False):
        self.num_heads = num_heads
        self.block = block
        self.different_layout_per_head = different_layout_per_head
        self.num_layout_heads = num_heads if different_layout_per_head else 1

    def setup_layout(self, seq_len):
        if seq_len % self.block != 0:
            raise ValueError(
                f"Sequence Length {seq_len} must be divisible by block size "
                f"{self.block}")
        n = seq_len // self.block
        return np.zeros((self.num_heads, n, n), dtype=np.int64)

    def check_and_propagate_first_head_layout(self, layout):
        if not self.different_layout_per_head:
            layout[1:] = layout[0]
        return layout

    def _causal_clip(self, layout, h):
        """Zero the strict upper triangle for unidirectional attention."""
        n = layout.shape[1]
        layout[h] &= np.tril(np.ones((n, n), dtype=np.int64))
        return layout


class DenseSparsityConfig(SparsityConfig):
    """All blocks on — for comparison/debug (reference :63-94)."""

    def make_layout(self, seq_len):
        layout = self.setup_layout(seq_len)
        layout[:] = 1
        return layout


class FixedSparsityConfig(SparsityConfig):
    """Sparse-Transformer-style fixed pattern: non-overlapping local windows
    + fixed global block columns (reference :97-243; Child et al. 2019)."""

    def __init__(self, num_heads, block=16, different_layout_per_head=False,
                 num_local_blocks=4, num_global_blocks=1,
                 attention="bidirectional", horizontal_global_attention=False,
                 num_different_global_patterns=1):
        super().__init__(num_heads, block, different_layout_per_head)
        if num_local_blocks % num_global_blocks != 0:
            raise ValueError(
                f"num_local_blocks {num_local_blocks} must be divisible by "
                f"num_global_blocks {num_global_blocks}")
        if attention not in ("unidirectional", "bidirectional"):
            raise NotImplementedError(
                'only "uni/bi-directional" attentions are supported')
        if attention != "bidirectional" and horizontal_global_attention:
            raise ValueError(
                'only "bi-directional" attention supports horizontal global '
                'attention')
        if num_different_global_patterns > 1 and not different_layout_per_head:
            raise ValueError(
                "multiple global patterns require different_layout_per_head")
        if num_different_global_patterns > num_local_blocks // num_global_blocks:
            raise ValueError(
                f"num_different_global_patterns "
                f"{num_different_global_patterns} cannot exceed "
                f"{num_local_blocks // num_global_blocks}")
        self.num_local_blocks = num_local_blocks
        self.num_global_blocks = num_global_blocks
        self.attention = attention
        self.horizontal_global_attention = horizontal_global_attention
        self.num_different_global_patterns = num_different_global_patterns

    def set_local_layout(self, h, layout):
        n = layout.shape[1]
        for start in range(0, n, self.num_local_blocks):
            end = min(start + self.num_local_blocks, n)
            layout[h, start:end, start:end] = 1
        if self.attention == "unidirectional":
            self._causal_clip(layout, h)
        return layout

    def set_global_layout(self, h, layout):
        n = layout.shape[1]
        # representative block of each window, rotated per head pattern
        first = self.num_local_blocks - (
            1 + h % self.num_different_global_patterns) * self.num_global_blocks
        end = n - (n % self.num_local_blocks)
        cols = list(range(first, end, self.num_local_blocks))
        # short trailing window keeps a (clamped) representative too
        if end < n:
            cols.append(min(end + first, n - self.num_global_blocks))
        for c in cols:
            first_row = 0 if self.attention == "bidirectional" else c
            layout[h, first_row:, c:c + self.num_global_blocks] = 1
            if self.horizontal_global_attention:
                layout[h, c:c + self.num_global_blocks, :] = 1
        return layout

    def make_layout(self, seq_len):
        layout = self.setup_layout(seq_len)
        for h in range(self.num_layout_heads):
            layout = self.set_local_layout(h, layout)
            layout = self.set_global_layout(h, layout)
        return self.check_and_propagate_first_head_layout(layout)


class VariableSparsityConfig(SparsityConfig):
    """Fixed pattern generalized: random blocks + variable-width local
    windows + user-chosen global indices (reference :246-419)."""

    def __init__(self, num_heads, block=16, different_layout_per_head=False,
                 num_random_blocks=0, local_window_blocks=None,
                 global_block_indices=None, global_block_end_indices=None,
                 attention="bidirectional", horizontal_global_attention=False):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_random_blocks = num_random_blocks
        self.local_window_blocks = local_window_blocks or [4]
        self.global_block_indices = global_block_indices \
            if global_block_indices is not None else [0]
        if global_block_end_indices is not None:
            if len(self.global_block_indices) != len(global_block_end_indices):
                raise ValueError(
                    "global_block_indices and global_block_end_indices must "
                    "have equal length")
            for s, e in zip(self.global_block_indices,
                            global_block_end_indices):
                if s >= e:
                    raise ValueError(
                        f"global block start {s} must be < end {e}")
        self.global_block_end_indices = global_block_end_indices
        if attention not in ("unidirectional", "bidirectional"):
            raise NotImplementedError(
                'only "uni/bi-directional" attentions are supported')
        if attention != "bidirectional" and horizontal_global_attention:
            raise ValueError(
                'only "bi-directional" attention supports horizontal global '
                'attention')
        self.attention = attention
        self.horizontal_global_attention = horizontal_global_attention

    def set_random_layout(self, h, layout):
        n = layout.shape[1]
        if n < self.num_random_blocks:
            raise ValueError(
                f"num_random_blocks {self.num_random_blocks} must be < "
                f"number of block rows {n}")
        for row in range(n):
            cols = random.sample(range(n), self.num_random_blocks)
            layout[h, row, cols] = 1
        return layout

    def set_local_layout(self, h, layout):
        n = layout.shape[1]
        start = 0
        for size in self.local_window_blocks:
            end = min(start + size, n)
            layout[h, start:end, start:end] = 1
            start += size
        # remaining windows reuse the last listed width
        while start < n:
            end = min(start + size, n)
            layout[h, start:end, start:end] = 1
            start += size
        if self.attention == "unidirectional":
            self._causal_clip(layout, h)
        return layout

    def set_global_layout(self, h, layout):
        n = layout.shape[1]
        if self.global_block_end_indices is None:
            spans = [(i, i + 1) for i in self.global_block_indices]
        else:
            spans = list(zip(self.global_block_indices,
                             self.global_block_end_indices))
        for s, e in spans:
            if s >= n:
                continue
            e = min(e, n)
            first_row = 0 if self.attention == "bidirectional" else s
            layout[h, first_row:, s:e] = 1
            if self.horizontal_global_attention:
                layout[h, s:e, :] = 1
        return layout

    def make_layout(self, seq_len):
        layout = self.setup_layout(seq_len)
        for h in range(self.num_layout_heads):
            layout = self.set_random_layout(h, layout)
            layout = self.set_local_layout(h, layout)
            layout = self.set_global_layout(h, layout)
        return self.check_and_propagate_first_head_layout(layout)


class BigBirdSparsityConfig(SparsityConfig):
    """BigBird ITC: random + sliding window + leading global blocks
    (reference :422-541; Zaheer et al. 2020)."""

    def __init__(self, num_heads, block=16, different_layout_per_head=False,
                 num_random_blocks=1, num_sliding_window_blocks=3,
                 num_global_blocks=1):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_random_blocks = num_random_blocks
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.num_global_blocks = num_global_blocks

    def set_random_layout(self, h, layout):
        n = layout.shape[1]
        if n < self.num_random_blocks:
            raise ValueError(
                f"num_random_blocks {self.num_random_blocks} must be < {n}")
        for row in range(n):
            cols = random.sample(range(n), self.num_random_blocks)
            layout[h, row, cols] = 1
        return layout

    def set_sliding_window_layout(self, h, layout):
        n = layout.shape[1]
        if n < self.num_sliding_window_blocks:
            raise ValueError(
                f"num_sliding_window_blocks {self.num_sliding_window_blocks} "
                f"must be < {n}")
        w = self.num_sliding_window_blocks // 2
        rows = np.arange(n)[:, None]
        cols = np.arange(n)[None, :]
        layout[h] |= (np.abs(rows - cols) <= w).astype(np.int64)
        return layout

    def set_global_layout_itc(self, h, layout):
        n = layout.shape[1]
        if n < self.num_global_blocks:
            raise ValueError(
                f"num_global_blocks {self.num_global_blocks} must be < {n}")
        layout[h, :self.num_global_blocks, :] = 1
        layout[h, :, :self.num_global_blocks] = 1
        return layout

    def make_layout(self, seq_len):
        layout = self.setup_layout(seq_len)
        for h in range(self.num_layout_heads):
            layout = self.set_random_layout(h, layout)
            layout = self.set_sliding_window_layout(h, layout)
            layout = self.set_global_layout_itc(h, layout)
        return self.check_and_propagate_first_head_layout(layout)


class BSLongformerSparsityConfig(SparsityConfig):
    """Block-sparse Longformer: sliding window + symmetric global indices
    (reference :544-663; Beltagy et al. 2020)."""

    def __init__(self, num_heads, block=16, different_layout_per_head=False,
                 num_sliding_window_blocks=3, global_block_indices=None,
                 global_block_end_indices=None):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.global_block_indices = global_block_indices \
            if global_block_indices is not None else [0]
        if global_block_end_indices is not None:
            if len(self.global_block_indices) != len(global_block_end_indices):
                raise ValueError(
                    "global_block_indices and global_block_end_indices must "
                    "have equal length")
            for s, e in zip(self.global_block_indices,
                            global_block_end_indices):
                if s >= e:
                    raise ValueError(
                        f"global block start {s} must be < end {e}")
        self.global_block_end_indices = global_block_end_indices

    def set_sliding_window_layout(self, h, layout):
        n = layout.shape[1]
        if n < self.num_sliding_window_blocks:
            raise ValueError(
                f"num_sliding_window_blocks {self.num_sliding_window_blocks} "
                f"must be < {n}")
        w = self.num_sliding_window_blocks // 2
        rows = np.arange(n)[:, None]
        cols = np.arange(n)[None, :]
        layout[h] |= (np.abs(rows - cols) <= w).astype(np.int64)
        return layout

    def set_global_layout(self, h, layout):
        n = layout.shape[1]
        if self.global_block_end_indices is None:
            spans = [(i, i + 1) for i in self.global_block_indices]
        else:
            spans = list(zip(self.global_block_indices,
                             self.global_block_end_indices))
        for s, e in spans:
            if s >= n:
                continue
            e = min(e, n)
            layout[h, s:e, :] = 1
            layout[h, :, s:e] = 1
        return layout

    def make_layout(self, seq_len):
        layout = self.setup_layout(seq_len)
        for h in range(self.num_layout_heads):
            layout = self.set_sliding_window_layout(h, layout)
            layout = self.set_global_layout(h, layout)
        return self.check_and_propagate_first_head_layout(layout)
