"""N-D process topology + parallel grid: the rank-mapping layer.

Port of deepspeed_tpu/runtime/pipe/topology.py, a copy (pure Python; the
reference is deepspeed/runtime/pipe/topology.py:12-455). The coordinate
math names each rank's place on the (pipe, data, model) grid; the
``torch.distributed`` groups themselves are built from the same grid by
parallel/mesh.py ``ProcessGrid`` and utils/distributed.py
``grid_groups``. Axis order is row-major: axes=['pipe','data','model']
puts model innermost (reference topology.py:246 does the same for
NVLink).
"""
import itertools
from collections import namedtuple


class ProcessTopology:
    """Maps n-D cartesian coordinates with named axes to linear ranks
    (row-major). Reference: topology.py:12-219."""

    def __init__(self, axes, dims):
        assert len(axes) == len(dims)
        self.axes = list(axes)
        self.dims = list(dims)
        self.ProcessCoord = namedtuple("ProcessCoord", self.axes)
        self.mapping = {
            self.ProcessCoord(*coord): rank
            for rank, coord in enumerate(
                itertools.product(*[range(d) for d in dims]))
        }
        self._by_rank = {r: c for c, r in self.mapping.items()}

    def get_rank(self, **coords):
        if len(coords) != len(self.axes):
            raise ValueError(
                "get_rank() needs a full coordinate; use filter_match() for slices")
        key = self.ProcessCoord(**coords)
        assert key in self.mapping, f"invalid coordinate {coords}"
        return self.mapping[key]

    def get_axis_names(self):
        return self.axes

    def get_rank_repr(self, rank, omit_axes=("data", "pipe"), inner_sep="_",
                      outer_sep="-"):
        """Checkpoint-name fragment for a rank, e.g. 'model_00'
        (reference topology.py:69-102)."""
        omit = frozenset(omit_axes)
        coord = self.get_coord(rank)
        return outer_sep.join(
            f"{ax}{inner_sep}{getattr(coord, ax):02d}"
            for ax in self.axes if ax not in omit)

    def get_dim(self, axis):
        return self.dims[self.axes.index(axis)] if axis in self.axes else 0

    def get_coord(self, rank):
        if rank not in self._by_rank:
            raise ValueError(f"rank {rank} not in topology")
        return self._by_rank[rank]

    def get_axis_comm_lists(self, axis):
        """All rank lists that vary only along `axis` — the communicator
        groups for that axis (reference topology.py:131-169)."""
        if axis not in self.axes:
            return []
        others = [a for a in self.axes if a != axis]
        lists = []
        for combo in itertools.product(*[range(self.get_dim(a)) for a in others]):
            fixed = dict(zip(others, combo))
            lists.append([self.get_rank(**fixed, **{axis: i})
                          for i in range(self.get_dim(axis))])
        return lists

    def filter_match(self, **criteria):
        """Ranks whose coordinates match all criteria (reference :171-195)."""
        return sorted(
            rank for coord, rank in self.mapping.items()
            if all(getattr(coord, k) == v for k, v in criteria.items()))

    def get_axis_list(self, axis, idx):
        return self.filter_match(**{axis: idx})

    def world_size(self):
        return len(self.mapping)

    def __str__(self):
        return str(self.mapping)


class PipeDataParallelTopology(ProcessTopology):
    """pipe x data: DP innermost so gradient reductions use the
    high-bandwidth links (reference topology.py:235-243)."""

    def __init__(self, num_pp, num_dp):
        super().__init__(axes=["pipe", "data"], dims=[num_pp, num_dp])


class PipeModelDataParallelTopology(ProcessTopology):
    """pipe x data x model: TP innermost (reference topology.py:246-249)."""

    def __init__(self, num_pp, num_mp, num_dp):
        super().__init__(axes=["pipe", "data", "model"],
                         dims=[num_pp, num_dp, num_mp])


class PipelineParallelGrid:
    """Stage/data/model coordinate bookkeeping for one rank + the mpu-style
    interface (reference topology.py:252-455).

    Group-returning methods yield rank lists, not communicator handles:
    utils/distributed.py builds the ``torch.distributed`` groups of the
    same lines. `as_mesh_shape()` gives the mesh dict of the config.
    """

    def __init__(self, topology=None, process_group=None, rank=0,
                 world_size=None, virtual_stages=1):
        if topology is None:
            assert world_size is not None
            topology = PipeDataParallelTopology(num_pp=1, num_dp=world_size)
        self._topo = topology
        self.global_rank = rank
        self.world_size = topology.world_size()
        # interleaved virtual stages: each physical stage owns
        # ``virtual_stages`` non-contiguous model chunks (Megatron
        # interleaving); chunk q lives on stage q % pipe and is that
        # stage's local chunk q // pipe
        self.virtual_stages = max(1, int(virtual_stages))

        coord = self._topo.get_coord(rank)
        self.stage_id = getattr(coord, "pipe", 0)
        self.data_parallel_id = getattr(coord, "data", 0)
        self.model_parallel_id = getattr(coord, "model", 0)
        self.slice_parallel_id = self.model_parallel_id

        self.pipe_parallel_size = max(1, self._topo.get_dim("pipe"))
        self.data_parallel_size = max(1, self._topo.get_dim("data"))
        self.model_parallel_size = max(1, self._topo.get_dim("model"))

        self.pp_group = self._group_containing("pipe")
        self.dp_group = self._group_containing("data")
        self.slice_group = self._group_containing("model")

        # adjacent-stage p2p pairs incl. wraparound (reference :372-387)
        self.p2p_groups = self._build_p2p_groups()

    def _group_containing(self, axis):
        if self._topo.get_dim(axis) == 0:
            return [self.global_rank]
        for group in self._topo.get_axis_comm_lists(axis):
            if self.global_rank in group:
                return group
        raise AssertionError(f"rank {self.global_rank} in no {axis} group")

    def _build_p2p_groups(self):
        if self._topo.get_dim("pipe") <= 1:
            return []
        pairs = []
        for group in self._topo.get_axis_comm_lists("pipe"):
            for i, rank in enumerate(group):
                pairs.append(sorted([rank, group[(i + 1) % len(group)]]))
        return pairs

    def ppermute_perm(self, reverse=False):
        """(src, dst) stage pairs of a shift over 'pipe': forward
        shifts activations to the next stage, reverse shifts grads back."""
        n = self.pipe_parallel_size
        if reverse:
            return [(i, (i - 1) % n) for i in range(n)]
        return [(i, (i + 1) % n) for i in range(n)]

    def as_mesh_shape(self):
        return {"pipe": self.pipe_parallel_size,
                "data": self.data_parallel_size,
                "model": self.model_parallel_size}

    # --- virtual-stage (model chunk) coordinates ---------------------------
    @property
    def num_model_chunks(self):
        return self.pipe_parallel_size * self.virtual_stages

    def chunk_owner_stage(self, chunk):
        """Physical stage holding global model chunk ``chunk`` (that
        stage's local chunk index is chunk // pipe)."""
        assert 0 <= chunk < self.num_model_chunks, f"chunk {chunk} invalid"
        return chunk % self.pipe_parallel_size

    # --- stage predicates -------------------------------------------------
    def is_first_stage(self):
        return self.stage_id == 0

    def is_last_stage(self):
        return self.stage_id == self.pipe_parallel_size - 1

    def stage_to_global(self, stage_id, data=None, model=None):
        coords = {"pipe": stage_id,
                  "data": self.data_parallel_id if data is None else data}
        if "model" in self._topo.get_axis_names():
            coords["model"] = self.model_parallel_id if model is None else model
        return self._topo.get_rank(**coords)

    def topology(self):
        return self._topo

    # --- mpu-compatible interface (reference topology.py:398-455) ---------
    def get_global_rank(self):
        return self.global_rank

    def get_pipe_parallel_rank(self):
        return self.stage_id

    def get_pipe_parallel_world_size(self):
        return self.pipe_parallel_size

    def get_pipe_parallel_group(self):
        return self.pp_group

    def get_data_parallel_rank(self):
        return self.data_parallel_id

    def get_data_parallel_world_size(self):
        return self.data_parallel_size

    def get_data_parallel_group(self):
        return self.dp_group

    def get_model_parallel_rank(self):
        return self.model_parallel_id

    def get_model_parallel_world_size(self):
        return self.model_parallel_size

    def get_model_parallel_group(self):
        return self.slice_group

    def get_slice_parallel_rank(self):
        return self.slice_parallel_id

    def get_slice_parallel_world_size(self):
        return self.model_parallel_size

    def get_slice_parallel_group(self):
        return self.slice_group
