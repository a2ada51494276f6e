"""The data-parallel plumbing of the PyTorch port in one process, against
the JAX package where both have the function: the rendezvous
(utils/distributed.py), the data axis (parallel/mesh.py), the comm volume
accounting, the ZeRO optimizer gate, the runtime helpers (partitioning,
PartitionedTensor, global norm, overflow, clipping), the dataloader, and
the refusals that name what is not ported. The gloo worlds are in
tests/test_torch_zero.py.
"""
import ast
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import deepspeed_tpu_torch
import torch_zero_worker as W
from deepspeed_tpu.runtime import comm_accounting as jca
from deepspeed_tpu.runtime import utils as jutils
from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2Model
from deepspeed_tpu_torch.parallel import mesh
from deepspeed_tpu_torch.runtime import comm_accounting as ca
from deepspeed_tpu_torch.runtime import utils
from deepspeed_tpu_torch.runtime.dataloader import (DeepSpeedDataLoader,
                                                    RepeatingLoader)
from deepspeed_tpu_torch.runtime.zero.utils import (
    ZeRORuntimeException, assert_zero_supported_optimizer,
    is_zero_supported_optimizer)
from deepspeed_tpu_torch.utils import distributed

_WORLD_ENV = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE",
              "LOCAL_RANK", "LOCAL_WORLD_SIZE", "OMPI_COMM_WORLD_RANK",
              "OMPI_COMM_WORLD_SIZE", "PMI_RANK", "SLURM_PROCID")


@pytest.fixture
def clean_env(monkeypatch):
    for key in _WORLD_ENV:
        # set, then delete: the undo then also removes a key the test
        # writes into os.environ itself (mpi_discovery does), which a bare
        # delenv of an absent key would leave behind for later tests
        monkeypatch.setenv(key, "")
        monkeypatch.delenv(key)
    assert not dist.is_initialized()
    return monkeypatch


def _world_env(env, world=2, rank=0):
    for key, value in dict(MASTER_ADDR="127.0.0.1", MASTER_PORT="29511",
                           RANK=str(rank), WORLD_SIZE=str(world),
                           LOCAL_RANK=str(rank)).items():
        env.setenv(key, value)


# ---------------------------------------------------------------------------
# the rendezvous
# ---------------------------------------------------------------------------
def test_init_distributed_without_a_named_world_is_a_no_op(clean_env):
    deepspeed_tpu_torch.init_distributed(device="cpu")
    assert not dist.is_initialized()
    assert distributed.get_rank() == 0 and distributed.get_world_size() == 1


@pytest.mark.parametrize("case", ["no_cuda", "gloo_on_cuda",
                                  "more_ranks_than_cards"])
def test_init_distributed_on_cuda_never_falls_back(clean_env, case):
    """On CUDA the backend is NCCL or the call raises: no CUDA, a gloo
    backend asked for, or a world larger than the node's cards."""
    _world_env(clean_env)
    if case == "no_cuda":
        clean_env.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            distributed.init_distributed()
    elif case == "gloo_on_cuda":
        with pytest.raises(ValueError, match="runs nccl"):
            distributed.init_distributed(dist_backend="gloo", device="cuda")
    else:
        clean_env.setattr(torch.cuda, "is_available", lambda: True)
        clean_env.setattr(torch.cuda, "device_count", lambda: 1)
        with pytest.raises(RuntimeError, match="one device per process"):
            distributed.init_distributed()
    assert not dist.is_initialized()


def test_mpi_discovery_fills_the_env_or_needs_mpi4py(clean_env):
    clean_env.setenv("OMPI_COMM_WORLD_RANK", "1")
    clean_env.setenv("OMPI_COMM_WORLD_SIZE", "4")
    with pytest.raises(RuntimeError, match="mpi4py"):
        distributed.mpi_discovery()
    clean_env.setenv("MASTER_ADDR", "10.0.0.7")
    assert distributed.mpi_discovery(29600) == (1, 4, "10.0.0.7")
    assert (os.environ["RANK"], os.environ["WORLD_SIZE"],
            os.environ["MASTER_PORT"]) == ("1", "4", "29600")


# ---------------------------------------------------------------------------
# the data axis and the refusals
# ---------------------------------------------------------------------------
def _config(**extra):
    return dict(W.ds_config(1, 2, 1), **extra)


def _initialize(config, **kw):
    return deepspeed_tpu_torch.initialize(
        model=GPT2Model(GPT2Config(dtype=torch.float32, **W.TINY)),
        config_params=config, device="cpu", **kw)


def test_mesh_data_must_be_the_world(clean_env):
    with pytest.raises(ValueError, match="mesh data=2, but the world has 1"):
        _initialize(_config(mesh={"data": 2}))
    eng = _initialize(_config(mesh={"data": -1}))[0]
    assert eng.dp_world_size == 1 and eng.dp_group is None
    assert mesh.resolve_grid({"data": 4}, 4)["data"] == 4


@pytest.mark.parametrize("shape,world,match", [
    ({"data": 1, "seq": 2}, 4, "covers 2 of the world's 4 processes"),
    ({"data": 1, "seq": 2, "allow_partial": True}, 4,
     "must cover the world exactly"),
    ({"seq": 3}, 4, "4 devices not divisible by fixed axes product 3"),
])
def test_the_mesh_must_cover_the_world(shape, world, match):
    """The port has no partial mesh: every process of the world holds a
    place in it, whatever ``allow_partial`` says (the JAX engine's opt-in
    to train on a subset of its devices)."""
    with pytest.raises(ValueError, match=match):
        mesh.resolve_grid(shape, world)
    assert mesh.resolve_grid({"data": 2, "seq": 2}, 4) == {
        "pipe": 1, "data": 2, "seq": 2, "model": 1}


@pytest.mark.parametrize("extra,item", [
    ({"mesh": {"model": 2}}, "A7b"),
    ({"mesh": {"pipe": 2}}, "A12"),
    ({"mesh": {"seq": 2}}, "A15"),
    ({"mpu": object()}, "A7b"),
])
def test_unported_parallelism_names_its_item(clean_env, extra, item):
    """The axes still to come raise naming their item; ``seq``, ported by
    A15, and ``model``, ported by A7b, are the grid's now: seq 2 or model
    2 in a world of one raises the JAX mesh's message, and an ``mpu``
    without the topology's interface raises ValueError."""
    kw = {"mpu": extra.pop("mpu")} if "mpu" in extra else {}
    if kw:
        with pytest.raises(ValueError, match="the mpu has no "
                           "get_model_parallel_world_size"):
            _initialize(_config(**extra), **kw)
        return
    if item in ("A15", "A7b"):
        with pytest.raises(ValueError, match="1 devices not divisible by "
                           "fixed axes product 2"):
            _initialize(_config(**extra), **kw)
        return
    with pytest.raises(NotImplementedError, match=item):
        _initialize(_config(**extra), **kw)


# ---------------------------------------------------------------------------
# comm accounting, ZeRO gate, partitioning helpers
# ---------------------------------------------------------------------------
def test_comm_accounting_matches_jax():
    rng = np.random.default_rng(0)
    shapes = [tuple(int(x) for x in rng.choice([3, 4, 8, 12, 96], nd))
              for nd in rng.integers(0, 4, 24)]
    for dp in (1, 2, 3, 4):
        assert [ca.zero_shard_dim(s, dp, (0,)) for s in shapes] == \
            [jca.zero_shard_dim(s, dp, (0,)) for s in shapes]
        for gas, dtype in ((1, "bfloat16"), (3, "float32")):
            ours = ca.volume_report(
                [ca.LeafSpec(f"l{i}", s, ca.zero_shard_dim(s, dp))
                 for i, s in enumerate(shapes)], dp, gas=gas,
                param_dtype=dtype)
            theirs = jca.volume_report(
                [jca.LeafSpec(f"l{i}", s, jca.zero_shard_dim(s, dp))
                 for i, s in enumerate(shapes)], dp, gas=gas,
                param_dtype=dtype)
            assert ours["collectives"] == theirs["collectives"]
            for key in ("grad_exchange_bytes_per_step",
                        "param_gather_bytes_per_step", "total_bytes_per_step",
                        "baseline", "grad_reduction_vs_fp32"):
                assert ours[key] == theirs[key], key
    # the quantized branches (qgZ flat and hierarchical, qwZ), ported in
    # full: the same records, byte for byte
    for dp, k in ((2, 0), (4, 2), (4, 0)):
        kw = dict(gas=2, quantized_gradients=True, quantized_weights=True,
                  block_size=32, intra_size=k, param_gathers_per_step=2,
                  implicit_param_gathers_per_step=4)
        ours = ca.volume_report(
            [ca.LeafSpec(f"l{i}", s, ca.zero_shard_dim(s, dp))
             for i, s in enumerate(shapes)], dp, **kw)
        theirs = jca.volume_report(
            [jca.LeafSpec(f"l{i}", s, jca.zero_shard_dim(s, dp))
             for i, s in enumerate(shapes)], dp, **kw)
        assert ours == theirs
    assert ca.dtype_bytes(torch.bfloat16) == 2


def test_collective_counter_sums_micro_steps_per_leaf():
    counter = ca.CollectiveCounter()
    for _ in range(3):
        counter.record("reduce-scatter", "grad_rs", torch.float32,
                       [("a", 8), ("b", 4)], 4)
    counter.record_scalar()
    got = counter.take()
    want = ca.grad_exchange_collectives(
        [ca.LeafSpec("a", (8,), 0), ca.LeafSpec("b", (4,), 0)], 4,
        count_per_step=3)
    assert got["collectives"] == ca._as_dicts(want)
    assert got["calls"] == {"reduce-scatter": 3} and got["scalars"] == 1
    assert counter.take()["collectives"] == []


def test_zero_supported_optimizers():
    from deepspeed_tpu_torch.ops.adam.fused_adam import FusedAdam
    from deepspeed_tpu_torch.ops.adam.sgd import SGD
    from deepspeed_tpu_torch.ops.lamb.fused_lamb import FusedLamb

    for opt in (FusedAdam(), FusedLamb(), SGD()):
        assert is_zero_supported_optimizer(opt)
        assert_zero_supported_optimizer(opt, allow_untested=False)
    other = torch.optim.SGD([torch.zeros(1, requires_grad=True)], lr=1.0)
    assert not is_zero_supported_optimizer(other)
    assert_zero_supported_optimizer(other, allow_untested=True)
    with pytest.raises(ZeRORuntimeException, match="not ZeRO-supported"):
        assert_zero_supported_optimizer(other, allow_untested=False)


@pytest.mark.parametrize("items,parts", [(10, 3), (3, 5), (24, 4), (7, 7)])
def test_partition_helpers_match_jax(items, parts):
    assert utils.partition_uniform(items, parts) == \
        jutils.partition_uniform(items, parts)
    weights = list(np.random.default_rng(items).integers(1, 9, items))
    assert utils.partition_balanced(weights, parts) == \
        jutils.partition_balanced(weights, parts)
    x = np.random.default_rng(parts).standard_normal((items, 3)) \
        .astype(np.float32)
    ours = [utils.PartitionedTensor(torch.from_numpy(x), parts, i)
            for i in range(parts)]
    theirs = [jutils.PartitionedTensor(jnp.asarray(x), parts, i)
              for i in range(parts)]
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a.data().numpy(), np.asarray(b.data()))
        assert a.to_meta() == b.to_meta()
    full = utils.PartitionedTensor.from_parts(
        [a.data() for a in ours], ours[0].to_meta())
    np.testing.assert_array_equal(full.full([a.data() for a in ours]), x)


class _TwinGroup:
    """A stand-in for a group of two ranks that hold the same values: an
    all-reduce SUM doubles, a MAX keeps."""

    def __init__(self):
        self.calls = []

    def all_reduce(self, t, leaves=(), op=dist.ReduceOp.SUM):
        self.calls.append(op)
        if op == dist.ReduceOp.SUM:
            t.mul_(2)
        return t


def test_norm_overflow_and_clip_match_jax_and_count_replicas_once():
    rng = np.random.default_rng(3)
    grads = [rng.standard_normal(s).astype(np.float32)
             for s in ((4, 6), (5,), (3, 2, 2))]
    t = [torch.from_numpy(g.copy()) for g in grads]
    j = [jnp.asarray(g) for g in grads]
    np.testing.assert_allclose(utils.global_norm_from_tree(t).item(),
                               float(jutils.global_norm_from_tree(j)),
                               rtol=1e-6)
    # shards summed over the group, a replicated tensor counted once
    group = _TwinGroup()
    got = utils.global_norm_from_tree(t, group, [True, False, True]).item()
    want = np.sqrt(2 * (np.sum(grads[0] ** 2) + np.sum(grads[2] ** 2))
                   + np.sum(grads[1] ** 2))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert not utils.has_overflow(t, group).item()
    assert group.calls[-1] == dist.ReduceOp.MAX
    bad = [x.clone() for x in t]
    bad[1][2] = float("nan")
    assert utils.has_overflow(bad).item() and bool(jutils.has_overflow(
        [jnp.asarray(x.numpy()) for x in bad]))
    norm = utils.clip_grad_by_global_norm(t, 1.0)
    clipped, jnorm = jutils.clip_grad_by_global_norm(j, 1.0)
    np.testing.assert_allclose(norm.item(), float(jnorm), rtol=1e-6)
    for a, b in zip(t, clipped):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)


# ---------------------------------------------------------------------------
# the dataloader
# ---------------------------------------------------------------------------
def test_repeating_loader_restarts():
    loader = RepeatingLoader([1, 2, 3])
    assert [next(loader) for _ in range(7)] == [1, 2, 3, 1, 2, 3, 1]


def test_dataloader_in_a_world_of_one(clean_env):
    from torch.utils.data import TensorDataset

    data = TensorDataset(torch.arange(10))
    loader = DeepSpeedDataLoader(data, batch_size=4)
    assert type(loader.data_sampler).__name__ == "RandomSampler"
    assert len(loader) == 3
    assert sorted(int(x) for (b,) in loader for x in b) == list(range(10))
    eng, _, train_loader, _ = _initialize(_config(), training_data=data)
    assert isinstance(train_loader, DeepSpeedDataLoader)
    assert train_loader.batch_size == eng.train_micro_batch_size_per_gpu()


def test_world_worker_imports_no_jax():
    path = os.path.join(os.path.dirname(__file__), "torch_zero_worker.py")
    roots = set()
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots.add(node.module.split(".")[0])
    assert not roots & {"jax", "flax", "deepspeed_tpu"}


@pytest.mark.parametrize("dp", [2, 4])
def test_zero_partition_of_a_scanned_stack_follows_jax(dp):
    """ZeroPartition on a scan-stacked GPT-2 (8 layers at n_embd 4, so
    the stacked LayerNorm leaves (8, 4) shard along their layer dim, whole
    layers per rank): each leaf's dim is zero_merge_spec's on the JAX
    tree, every
    element of every parameter is owned by exactly one rank, and a
    rank-major pack / unpack round trip is the identity."""
    import jax
    from jax.sharding import PartitionSpec as P

    from deepspeed_tpu.models.gpt2 import GPT2Config as JGPT2Config
    from deepspeed_tpu.models.gpt2 import GPT2Model as JGPT2Model
    from deepspeed_tpu.parallel.mesh import zero_merge_spec
    from deepspeed_tpu_torch.runtime.zero.partition import ZeroPartition

    sizes = dict(vocab_size=128, n_positions=16, n_embd=4, n_layer=8,
                 n_head=1, scan_layers=True)
    jmodel = JGPT2Model(JGPT2Config(dtype=jnp.float32, **sizes))
    ids = np.zeros((1, 8), np.int32)
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), {"input_ids": ids, "labels": ids}))
    specs = jax.tree_util.tree_leaves(jmodel.param_partition_spec(shapes),
                                      is_leaf=lambda x: isinstance(x, P))
    want = []
    for spec, leaf in zip(specs, jax.tree_util.tree_leaves(shapes)):
        z = tuple(zero_merge_spec(spec, leaf, dp))
        want.append(z.index("data") if "data" in z else None)
    model = GPT2Model(GPT2Config(dtype=torch.float32, **sizes))
    names = [n for n, _ in model.named_parameters()]
    params = [p.detach() for _, p in model.named_parameters()]
    parts = [ZeroPartition(model, names, params, dp, r, 2)
             for r in range(dp)]
    assert [leaf.shard_dim for leaf in parts[0].leaves] == want
    assert any(leaf.stacked and leaf.shard_dim == 0
               for leaf in parts[0].leaves)
    # ownership: each element in exactly one rank's shard
    for i in parts[0].sharded_idx:
        owned = torch.zeros_like(params[i])
        for part in parts:
            part.narrow(owned, i).add_(1)
        assert torch.all(owned == 1), names[i]
    # a rank-major round trip through one buffer
    full = [torch.randn_like(p) for p in params]
    buf = torch.empty(dp * parts[0].seg_size)
    parts[0].pack(buf, full)
    back = [torch.zeros_like(p) for p in params]
    parts[0].unpack(buf, back)
    for i in parts[0].sharded_idx:
        assert torch.equal(back[i], full[i])
