"""Tensor parallelism over the ``model`` axis in the PyTorch port
(parallel/tensor_parallel.py, the models' ``set_tensor_parallel``, the
engine at ``{"data": D, "model": M}``), on the CPU, against the JAX
package, fp32 unless stated, inputs from numpy seeds.

- Within one process, over a fake model group (``ThreadGroup``: one thread
  per model rank, its collectives summed across the threads): the
  vocabulary-parallel losses (chunked and dense) and the models at model 2
  (GPT-2 and BERT, dense and block-sparse, GPT-2 with dropout 0.1) equal
  one process at model 1: losses at rtol 1e-6, gradients within 1e-5 of
  the largest (reduction order only; bf16: one bf16 ulp of the largest).
  The two kinds of leaf the JAX spec replicates: a leaf a rank uses in part (BERT's ``qkv`` and
  ``ffn_inter`` biases, ``mlm_bias``) has a partial gradient on each rank,
  summed over the line (``tp_grad_ar``); a leaf every rank uses whole
  (LayerNorms, ``attn_out``'s bias) has the same gradient on every rank
  and is not summed.
- The engine in gloo worlds (tests/torch_tp_worlds.py) against
  ``deepspeed_tpu.initialize`` at the same mesh from the same initial
  parameters on the same global batches: GPT-2 at {"model": 2} (ZeRO 0)
  and {"data": 2, "model": 2} (ZeRO 0, 1, 2; bf16 and fp16 at ZeRO 2),
  BERT dense and block-sparse at {"model": 2}. Losses at rtol 1e-5
  (bf16: 5e-5, ROADMAP C-w18; fp16: 2e-5), masters at
  tests/test_torch_zero.py's rtol 1e-4, atol 1e-5 (bf16 and fp16: atol
  0.1 * lr, at most ``FLIP_SHARE`` of a leaf's elements beyond, each
  within 2 * steps * lr). An fp16 overflow on one rank alone skips
  the step on every rank. The comm report equals the JAX
  engine's, which prices the data axis at whole leaves and omits the
  model axis (ROADMAP C-w19); the counter holds the data axis's exchange
  at the rank's shards and the model axis's collectives in closed form.
  The analytic memory equals the JAX engine's at the same mesh (at fp32
  from ZeRO 1 but the master, C-w10).
- The port against itself: dropout 0.1 at model 2 equals model 1, and
  remat at model 2 equals no remat bit for bit.
- A tag written at {"data": 2, "model": 2} loads into the JAX engine,
  into the port at model 1 and at model 2, bit for bit.
- Every case tensor parallelism does not run beside yet raises
  NotImplementedError naming ROADMAP A7c.
"""
import os
import threading

import numpy as np
import pytest
import torch
import torch.distributed as dist

import deepspeed_tpu_torch
import torch_tp_worlds as TP
import torch_zero_worker as W
from deepspeed_tpu.runtime.checkpoint_utils import npz_dict_to_leaves
from deepspeed_tpu_torch.models.api import (chunked_lm_cross_entropy,
                                            cross_entropy_loss,
                                            param_partition_spec,
                                            replicated_spec)
from deepspeed_tpu_torch.models.convert import (bert_params_from_jax,
                                                model_rank_join,
                                                model_rank_shard,
                                                params_from_jax,
                                                tp_param_specs)
from deepspeed_tpu_torch.parallel import mesh
from deepspeed_tpu_torch.parallel.tensor_parallel import column_linear
from deepspeed_tpu_torch.runtime import comm_accounting as tca


# ---------------------------------------------------------------------------
# a fake model group: one thread per rank
# ---------------------------------------------------------------------------
class ThreadGroup:
    """A model line of ``size`` threads in one process: each collective
    deposits this rank's tensor, waits for every rank's, and reduces them
    in rank order (the interface of parallel/mesh.py
    ``ModelParallelGroup``)."""

    def __init__(self, shared, rank):
        self.shared, self.rank, self.size = shared, rank, len(shared[1])
        self.counter = tca.CollectiveCounter()

    def _exchange(self, t):
        barrier, slots = self.shared
        slots[self.rank] = t.detach().clone()
        barrier.wait()
        got = list(slots)
        barrier.wait()
        return got

    def all_reduce(self, t, name=None, prefix="tp_ar",
                   op=dist.ReduceOp.SUM):
        if name is not None:
            self.counter.record("all-reduce", prefix, t.dtype,
                                [(name, t.numel())], self.size)
        got = self._exchange(t)
        out = got[0].clone()
        for g in got[1:]:
            out = torch.maximum(out, g) if op == dist.ReduceOp.MAX \
                else out + g
        t.copy_(out)
        return t

    def all_gather(self, out, inp, leaves=()):
        got = self._exchange(inp)
        out.view(-1).copy_(torch.cat([g.reshape(-1) for g in got]))
        return out


def run_ranks(n, fn):
    """fn(group) on ``n`` threads, one per model rank; their results."""
    shared = (threading.Barrier(n), [None] * n)
    results, errors = [None] * n, []

    def go(r):
        try:
            results[r] = fn(ThreadGroup(shared, r))
        except Exception as e:          # raised below, the first one
            errors.append(e)
            shared[0].abort()

    threads = [threading.Thread(target=go, args=(r,)) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return results


# ---------------------------------------------------------------------------
# one process: the losses, the models, the replicated leaves
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("chunk", [0, 7])
def test_vocab_parallel_loss_matches_one_process(chunk):
    """The loss over vocabulary columns split over 2 ranks (pad columns on
    the last, ignored labels) equals the whole softmax, and so do the
    gradients of the hidden states and of each rank's rows of the head."""
    rng = np.random.default_rng(0)
    n, e, v, valid = 11, 8, 16, 13
    x0 = torch.from_numpy(rng.standard_normal((n, e)).astype(np.float32))
    w0 = torch.from_numpy(rng.standard_normal((v, e)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, valid, n))
    y[3] = -100

    def one(group):
        x = x0.clone().requires_grad_()
        w = (w0 if group is None else w0.chunk(2)[group.rank]).clone() \
            .requires_grad_()
        if chunk:
            loss, _ = chunked_lm_cross_entropy(
                x, w, y, chunk_tokens=chunk, ignore_index=-100,
                valid_vocab=valid, model_group=group)
        else:
            logits = column_linear(x, w, None, group, "head_bwd")
            if group is None:
                logits = logits[:, :valid]
            loss, _ = cross_entropy_loss(logits, y, ignore_index=-100,
                                         model_group=group,
                                         valid_vocab=valid)
        loss.backward()
        return loss.item(), x.grad, w.grad

    l1, gx, gw = one(None)
    ranks = run_ranks(2, one)
    for r, (loss, rx, rw) in enumerate(ranks):
        np.testing.assert_allclose(loss, l1, rtol=1e-6)
        np.testing.assert_allclose(rx.numpy(), gx.numpy(), atol=1e-6)
        np.testing.assert_allclose(rw.numpy(), gw.chunk(2)[r].numpy(),
                                   atol=1e-6)


def _tiny(kind, **over):
    if kind == "gpt2":
        return W.sp_model("gpt2", **over)
    return W.sp_model("bert", **over)


def _batch(kind):
    if kind == "gpt2":
        ids = torch.as_tensor(np.random.default_rng(1).integers(
            0, 128, (2, W.SEQ)))
        return {"input_ids": ids, "labels": ids}
    return {k: torch.as_tensor(v[0, 0]) for k, v in
            W.bert_batches(1, 1, 1, 2).items()}


def _grads(kind, group, over, batch):
    m = _tiny(kind, **over)
    if group is not None:
        m.set_tensor_parallel(group)
    loss, _ = m.loss(batch, generator=torch.Generator().manual_seed(5),
                     train=True)
    loss.backward()
    counted = group.counter.take() if group is not None else None
    return (loss.item(), {n: p.grad.clone() for n, p in m.named_parameters()},
            counted)


@pytest.mark.parametrize("kind,over", [
    ("gpt2", {}), ("gpt2", {"loss_chunk_tokens": 0}),
    ("gpt2", {"dropout": 0.1}), ("bert", {}), ("bert", {"sparse": True}),
    ("gpt2", {"dtype": torch.bfloat16}), ("bert", {"dtype": torch.bfloat16})])
def test_models_at_model_2_equal_one_process(kind, over):
    """A model's rank shards at model 2 (its layout from the whole model,
    ``set_tensor_parallel``) compute one process's loss, and their
    gradients joined (``model_rank_join``) are one process's; with
    dropout 0.1 too (the attention's masks through the hash's head
    offset, the replicated activations' drawn alike on every rank), and
    in bf16 (the row-parallel products' fp32 partials, ``_PartialProduct``,
    and the column-parallel input gradients' fp32 partials: a gradient
    within one bf16 ulp of its leaf's largest element; measured equal
    bit for bit on the CPU, where the one-process product also sums in
    fp32 and rounds once)."""
    batch = _batch(kind)
    l1, g1, _ = _grads(kind, None, over, batch)
    ranks = run_ranks(2, lambda g: _grads(kind, g, over, batch))
    for loss, _, _ in ranks:
        np.testing.assert_allclose(loss, l1, rtol=1e-6)
    joined = model_rank_join([r[1] for r in ranks],
                             tp_param_specs(_tiny(kind, **over)))
    assert set(joined) == set(g1)
    share = 2.0 ** -8 if over.get("dtype") == torch.bfloat16 else 1e-5
    for name, g in g1.items():
        g = g.float()
        np.testing.assert_allclose(joined[name].float().numpy(), g.numpy(),
                                   rtol=0,
                                   atol=share * float(g.abs().max()) + 1e-9,
                                   err_msg=name)


def test_replicated_leaves_used_in_part_are_summed_and_whole_ones_not():
    """ROADMAP A7b hazard (b). BERT at model 2: the leaves the JAX spec
    replicates but a rank uses in part (the ``qkv`` and ``ffn_inter``
    biases, ``mlm_bias``) take a partial gradient on each rank (zero
    outside its columns), and their sum over the line is one process's;
    the counter names exactly them under ``tp_grad_ar``. Leaves used
    whole (LayerNorms, ``attn_out``'s bias) take one process's gradient on
    every rank, unsummed."""
    batch = _batch("bert")
    _, g1, _ = _grads("bert", None, {}, batch)
    partial = {"encoder.layers.0.body.qkv.bias":
               "encoder/layer_0/body/qkv/bias",
               "encoder.layers.0.body.ffn_inter.bias":
               "encoder/layer_0/body/ffn_inter/bias",
               "mlm_bias": "mlm_bias"}
    whole = ["encoder.layers.0.body.attn_ln.weight",
             "encoder.layers.0.body.attn_out.bias", "mlm_ln.bias"]

    def unsummed(group):
        # the same rank without the sum: its own columns' part alone
        from deepspeed_tpu_torch.parallel import tensor_parallel as tp

        real = tp.copy_to_model

        def no_grad_sum(x, g, name, prefix="tp_ar"):
            return x if prefix == "tp_grad_ar" else real(x, g, name, prefix)

        tp.copy_to_model = no_grad_sum
        import deepspeed_tpu_torch.models.bert as bert

        bert.copy_to_model = no_grad_sum
        try:
            return _grads("bert", group, {}, batch)
        finally:
            tp.copy_to_model = bert.copy_to_model = real

    summed = run_ranks(2, lambda g: _grads("bert", g, {}, batch))
    for _, grads, counted in summed:
        names = {c["name"] for c in counted["collectives"]
                 if c["name"].startswith("tp_grad_ar:")}
        assert names == {f"tp_grad_ar:{p}" for p in partial.values()} | {
            "tp_grad_ar:encoder/layer_1/body/qkv/bias",
            "tp_grad_ar:encoder/layer_1/body/ffn_inter/bias"}
        for name in list(partial) + whole:
            np.testing.assert_allclose(grads[name].numpy(),
                                       g1[name].numpy(), atol=1e-6,
                                       err_msg=name)
    parts = run_ranks(2, unsummed)
    for name in partial:
        a, b = (p[1][name] for p in parts)
        # each rank's part is zero outside its columns, and the parts add
        # up to one process's gradient
        assert (a * b == 0).all() and (a != 0).any() and (b != 0).any()
        np.testing.assert_allclose((a + b).numpy(), g1[name].numpy(),
                                   atol=1e-6, err_msg=name)
    for name in whole:
        for p in parts:
            np.testing.assert_allclose(p[1][name].numpy(), g1[name].numpy(),
                                       atol=1e-6, err_msg=name)


def test_rank_shards_and_their_join_are_the_layout():
    """``model_rank_shard`` of a whole state_dict is what a rank keeps
    (``set_tensor_parallel``), ``c_attn``'s shard its heads' q, k and v
    columns; ``model_rank_join`` is the inverse. The layout description
    is the JAX ``param_partition_spec``'s."""
    whole = {n: p.detach().clone() for n, p in _tiny("gpt2").state_dict()
             .items()}
    kept = run_ranks(2, lambda g: {
        n: p.detach().clone() for n, p in
        (lambda m: (m.set_tensor_parallel(g), m)[1])(_tiny("gpt2"))
        .state_dict().items()})
    e = W.SP_GPT2["n_embd"]
    specs = tp_param_specs(_tiny("gpt2"))
    assert specs["h.0.attn.c_attn.weight"] == (0, 3)
    assert specs["h.0.attn.c_attn.bias"] == (0, 3)
    assert specs["h.0.attn.c_proj.weight"] == (1, 1)
    assert specs["wte"] == (0, 1)
    assert "h.0.attn.c_proj.bias" not in specs and "wpe" not in specs
    bspecs = tp_param_specs(_tiny("bert"))
    assert bspecs["encoder.layers.0.body.qkv.weight"] == (0, 3)
    assert bspecs["encoder.layers.0.body.ffn_out.weight"] == (1, 1)
    assert "encoder.layers.0.body.qkv.bias" not in bspecs
    assert "mlm_bias" not in bspecs
    for r in range(2):
        shard = model_rank_shard(whole, specs, r, 2)
        assert set(shard) == set(kept[r])
        for n in shard:
            assert torch.equal(shard[n], kept[r][n]), n
        qkv = whole["h.0.attn.c_attn.weight"]
        want = torch.cat([qkv[b * e + r * e // 2:b * e + (r + 1) * e // 2]
                          for b in range(3)])
        assert torch.equal(shard["h.0.attn.c_attn.weight"], want)
    joined = model_rank_join([model_rank_shard(whole, specs, r, 2)
                              for r in range(2)], specs)
    assert all(torch.equal(joined[n], whole[n]) for n in whole)
    spec = param_partition_spec(_tiny("gpt2"))
    assert spec["h_0/attn/c_attn/kernel"] == (None, "model")
    assert spec["h_0/attn/c_attn/bias"] == ("model",)
    assert spec["h_0/attn/c_proj/kernel"] == ("model", None)
    assert spec["h_0/attn/c_proj/bias"] == () and spec["wpe"] == ()
    assert spec["wte"] == ("model", None)
    bspec = param_partition_spec(_tiny("bert"))
    assert bspec["encoder/layer_0/body/qkv/bias"] == ()
    assert bspec["mlm_bias"] == ()
    assert set(replicated_spec(_tiny("gpt2")).values()) == {()}


def test_model_parallel_rng_folds_the_model_rank():
    """``model_parallel_rng`` (the JAX function's fold of 2718 + the
    ``model`` coordinate): a generator of its own per model rank, the same
    on every call, and the generator itself outside tensor parallelism."""
    from deepspeed_tpu_torch.runtime.activation_checkpointing.checkpointing \
        import model_parallel_rng

    gen = torch.Generator().manual_seed(11)
    assert model_parallel_rng(gen, None) is gen
    draws = run_ranks(2, lambda g: [
        torch.rand(4, generator=model_parallel_rng(gen, g))
        for _ in range(2)])
    for a, b in draws:
        assert torch.equal(a, b)
    assert not torch.equal(draws[0][0], draws[1][0])


def test_grid_takes_data_by_model_and_refuses_the_rest():
    """``resolve_grid`` lays {"data": D, "model": M} over D*M processes;
    ``model`` beside ``seq`` or ``pipe`` raises naming A7c."""
    assert mesh.resolve_grid({"data": 2, "model": 2}, 4) == {
        "pipe": 1, "data": 2, "seq": 1, "model": 2}
    assert mesh.resolve_grid({"model": 4}, 4)["data"] == 1
    grid = mesh.ProcessGrid(mesh.resolve_grid({"data": 2, "model": 2}, 4),
                            3)
    assert grid.coords["data"] == 1 and grid.coords["model"] == 1
    assert grid.line("model") == [2, 3] and grid.line("data") == [1, 3]
    for bad in ({"model": 2, "seq": 2}, {"model": 2, "pipe": 2}):
        with pytest.raises(NotImplementedError, match="A7c"):
            mesh.resolve_grid(bad, 4)


# ---------------------------------------------------------------------------
# the engine in gloo worlds
# ---------------------------------------------------------------------------
@pytest.fixture(scope="session")
def world(tmp_path_factory):
    return W.session_worlds(tmp_path_factory, TP.WORLDS, TP.COMPANIONS)


def model_axis_collectives(case, micro=W.MICRO):
    """{name: (op, elements, dtype, count per step)} of the model axis in
    one step of ``case``, in closed form: per micro step the embedding's
    lookup sum, per block the two row-parallel all-reduces forward and
    the two column-parallel ones backward, the head's input backward, the
    loss's max and (sum, gold) over the tokens; BERT also the partial
    biases' gradient sums. The partial sums (``tp_ar``) are fp32 at any
    compute dtype; the lookup's and the biases' sums, which add one
    nonzero term per element, are in the compute dtype."""
    _, kind, _, _, over, dtype, _ = TP.CASES[case]
    es = {"fp32": "float32", "bf16": "bfloat16", "fp16": "float16"}[dtype]
    f32 = "float32"
    gas = TP.GAS
    if kind == "gpt2":
        e, layers, s = W.SP_GPT2["n_embd"], W.SP_GPT2["n_layer"], W.SEQ
        act = micro * s * e
        out = {"tp_vocab:wte": ("all-reduce", act, es)}
        for i in range(layers):
            for site in ("attn/c_proj", "mlp/c_proj", "attn/c_attn_bwd",
                         "mlp/c_fc_bwd"):
                out[f"tp_ar:h_{i}/{site}"] = ("all-reduce", act, f32)
        tokens = micro * (s - 1)
        out["tp_ar:head_bwd"] = ("all-reduce", tokens * e, f32)
        out["tp_vocab:loss/max"] = ("all-reduce", tokens, "float32")
        out["tp_vocab:loss/sum"] = ("all-reduce", 2 * tokens, "float32")
    else:
        cfg = W.SP_BERT
        e, s = cfg["hidden_size"], W.SP_BERT_SEQ
        act = micro * s * e
        out = {"tp_vocab:embeddings/word_embeddings": ("all-reduce", act,
                                                       es),
               "tp_ar:mlm_head_bwd": ("all-reduce", act, f32),
               "tp_vocab:mlm/max": ("all-reduce", micro * s, "float32"),
               "tp_vocab:mlm/sum": ("all-reduce", 2 * micro * s, "float32"),
               "tp_grad_ar:mlm_bias": ("all-reduce", 128, es)}
        for i in range(cfg["num_hidden_layers"]):
            p = f"encoder/layer_{i}/body"
            out.update({f"tp_ar:{p}/attn_out": ("all-reduce", act, f32),
                        f"tp_ar:{p}/ffn_out": ("all-reduce", act, f32),
                        f"tp_ar:{p}/qkv_bwd": ("all-reduce", act, f32),
                        f"tp_ar:{p}/ffn_inter_bwd": ("all-reduce", act,
                                                     f32),
                        f"tp_grad_ar:{p}/qkv/bias": ("all-reduce", 3 * e,
                                                     es),
                        f"tp_grad_ar:{p}/ffn_inter/bias": (
                            "all-reduce", cfg["intermediate_size"], es)})
    return {k: v + (gas,) for k, v in out.items()}


JAX_HELD = [c for c, v in TP.CASES.items() if v[-1]]


def test_engine_matches_the_jax_engine_at_the_same_mesh(world):
    """Every case of ``JAX_HELD`` (one test: the cases share worlds that
    are built once, and a test per case would only wait on them): every
    rank's losses and the gathered master against the JAX engine at the
    same mesh; every rank holds the same; the comm report is the JAX
    engine's, the counter the data axis's exchange at the rank's shards
    plus the model axis's collectives in closed form (C-w19); the analytic
    memory is the JAX engine's. The JAX engine restores the port's
    model-2 tag bit for bit."""
    for case in JAX_HELD:
        _assert_engine_matches_jax(world, case)
    # the JAX engine restored every leaf of the port's {"data": 2,
    # "model": 2} tag, then took one more step
    jax_load = TP.jax_result(world, "load")
    assert jax_load["same"] and jax_load["global_steps"] == TP.STEPS + 1


def _assert_engine_matches_jax(world, case):
    wname, kind, mesh_, stage, over, dtype, jname = TP.CASES[case]
    want = TP.jax_result(world, jname)
    ranks = TP.port_ranks(world, case)
    m = mesh_.get("model", 1)
    for r, got in enumerate(ranks):
        assert got["grid"] == (r // m, 0, r % m)
        np.testing.assert_allclose(got["losses"], want["losses"],
                                   rtol=TP.LOSS_RTOL[dtype],
                                   err_msg=f"{case} rank {r}")
        for name, a in got["master"].items():
            np.testing.assert_array_equal(a, ranks[0]["master"][name])
    W.assert_master_close(ranks[0]["master"], want["master"], TP.RTOL,
                          TP.MASTER_ATOL[dtype], TP.STEPS, TP.LR, case,
                          TP.FLIP_SHARE[dtype])
    # the report: the JAX engine's at any ZeRO stage of the same leaves
    got_report = ranks[0]["report"]
    if stage == 2 or mesh_.get("data", 1) == 1:
        assert got_report["collectives"] == want["report"]["collectives"]
        for key in ("grad_exchange_bytes_per_step",
                    "param_gather_bytes_per_step", "total_bytes_per_step"):
            assert got_report[key] == want["report"][key], key
    assert not any(c["name"].startswith("tp_")
                   for c in got_report["collectives"])
    dp = mesh_.get("data", 1)
    closed = model_axis_collectives(case)
    for rank in ranks:
        for step in rank["comm"]:
            counted = {c["name"]: c for c in step["collectives"]}
            tp = {k: v for k, v in counted.items() if k.startswith("tp_")}
            assert set(tp) == set(closed), case
            for name, (op, n, es, count) in closed.items():
                c = tp[name]
                assert (c["op"], c["elements"], c["dtype"],
                        c["count_per_step"], c["axis_size"]) == \
                    (op, n, es, count, m), (case, name)
                assert c["bytes_per_device"] == tca._RING_BYTES[op](
                    n, 4 if es == "float32" else 2, m), name
            data = {k: v for k, v in counted.items()
                    if not k.startswith("tp_")}
            if dp == 1:
                assert data == {}
                continue
            # the data axis: the report's records at the rank's shard of
            # each leaf the model axis splits (its whole over m)
            report = {c["name"]: c for c in got_report["collectives"]}
            if stage == 1:
                data = {k: v for k, v in data.items()
                        if not k.startswith("param_ag:")}
            assert set(data) == set(report), case
            for name, c in data.items():
                whole = report[name]["elements"]
                assert c["elements"] in (whole, whole // m), name
    if stage == 0 and dp == 1 or stage == 2:
        # the analytic memory: the JAX engine's at the same mesh (but at
        # fp32 from ZeRO 1, where the port keeps an fp32 master of its
        # own, C-w10)
        got_mem = dict(ranks[0]["memory"]["components"])
        want_mem = dict(want["memory"]["components"])
        if dtype == "fp32" and stage:
            got_mem.pop("master_bytes"), want_mem.pop("master_bytes")
        assert got_mem == want_mem, case


def test_an_overflow_on_one_model_rank_skips_the_step_everywhere(world):
    """fp16 at {"data": 2, "model": 2}, ZeRO 2: an inf planted in the
    first step's gradient of a leaf split over ``model``, on one rank
    alone (``TP.PLANT``). The overflow flag is a MAX over the whole world,
    so every rank skips that step (its master unmoved, the loss scale
    halved from 2**8) and takes the next, and every rank holds the same
    master after it."""
    ranks = [rank["overflow"] for rank in world("tp_w4")]
    for r, got in enumerate(ranks):
        assert got["moved"] == [False, True], r
        assert got["skipped"] == [1, 1], r
        assert got["scales"] == [2.0 ** 7] * 2, r
        for name, m in got["master"].items():
            np.testing.assert_array_equal(m, ranks[0]["master"][name],
                                          err_msg=f"rank {r} {name}")


def _port_engine(kind, over=None, init=None, stage=0, micro=W.MICRO,
                 **cfg):
    """The port at model 1 in this process (from the JAX initial
    parameters the JAX reference wrote, ``init``)."""
    module = W.sp_model(kind, **(over or {}))
    config = dict(W.ds_config(1, stage, TP.GAS, lr=TP.LR, micro=micro),
                  **cfg)
    eng = deepspeed_tpu_torch.initialize(model=module, config_params=config,
                                         device="cpu")[0]
    if init is not None:
        convert = params_from_jax if kind == "gpt2" else bert_params_from_jax
        eng.load_module_state_dict(convert(init, module.config))
    return eng


def test_dropout_and_remat_at_model_2_are_one_process(world):
    """Dropout 0.1 at model 2 (the engine's generator alike on every model
    rank, the attention's masks by the hash's head offset) equals the
    port at model 1 on the same batches; remat at model 2 replays its
    collectives and equals no remat bit for bit."""
    init = W.load_init(TP.init_path(_worlds_root(world), "gpt2"))
    eng = _port_engine("gpt2", {"dropout": 0.1}, init)
    batches = W.sp_batches("gpt2", TP.SEED, TP.STEPS, TP.GAS, W.MICRO)
    losses = [eng.train_batch(batch={k: v[s] for k, v in batches.items()})
              .item() for s in range(TP.STEPS)]
    for rank in TP.port_ranks(world, "gpt2_m2_dropout"):
        np.testing.assert_allclose(rank["losses"], losses, rtol=1e-5)
    W.assert_master_close(TP.port_ranks(world, "gpt2_m2_dropout")[0]
                          ["master"], W._full_master(eng), TP.RTOL, TP.ATOL,
                          TP.STEPS, TP.LR, "dropout")
    plain, remat = (TP.port_ranks(world, c)[0]
                    for c in ("gpt2_m2", "gpt2_m2_remat"))
    assert plain["losses"] == remat["losses"]
    for name, m in plain["master"].items():
        np.testing.assert_array_equal(remat["master"][name], m, name)


def _worlds_root(world):
    """The session's worlds directory (where the JAX initial parameters
    and the tag lie)."""
    saved = TP.port_ranks(world, "gpt2_d2m2_z2")[0]["saved"]
    return os.path.dirname(os.path.dirname(saved))


def test_model_2_tag_loads_into_the_port_at_model_1_and_2(world):
    """The tag written at {"data": 2, "model": 2} holds whole leaves in
    the JAX layout (the JAX engine's load: the test above): the port at
    model 1 (this process) and at model 2 (a world) restore every state
    leaf bit for bit, and one more step at model 1 gives the JAX engine's
    loss after its load."""
    saved = TP.port_ranks(world, "gpt2_d2m2_z2")[0]["saved"]
    with np.load(os.path.join(saved, "model_states.npz")) as data:
        leaves = npz_dict_to_leaves(data)
    # model 1, data 1: the global batch's rows on one rank
    eng = _port_engine("gpt2", stage=2, micro=2 * W.MICRO)
    eng.load_checkpoint(os.path.dirname(saved))
    got = eng._state_leaves()
    assert len(got) == len(leaves)
    for i, (a, b) in enumerate(zip(got[:-1], leaves[:-1])):
        np.testing.assert_array_equal(
            a.detach().cpu().numpy() if torch.is_tensor(a) else a,
            np.asarray(b), err_msg=str(i))
    batches = W.sp_batches("gpt2", TP.SEED, TP.STEPS + 1, TP.GAS,
                           2 * W.MICRO)
    loss = eng.train_batch(batch={k: v[TP.STEPS] for k, v in
                                  batches.items()}).item()
    np.testing.assert_allclose(loss, TP.jax_result(world, "load")["loss"],
                               rtol=1e-5)
    for rank in world("tp_w2"):
        got = rank["load"]["leaves"]
        assert len(got) == len(leaves)
        for i, (a, b) in enumerate(zip(got[:-1], leaves[:-1])):
            np.testing.assert_array_equal(a, np.asarray(b, a.dtype),
                                          err_msg=str(i))


_REFUSED_CONFIGS = {
    "stage3": {"zero_optimization": {"stage": 3}},
    "qwz": {"zero_optimization": {"stage": 2, "quantized_weights": True}},
    "qgz": {"zero_optimization": {"stage": 2, "quantized_gradients": True}},
    "offload": {"zero_optimization": {"stage": 2, "cpu_offload": True}},
    "onebit": {"optimizer": {"type": "OneBitAdam", "params": {"lr": 1e-3}}},
    "zeroone": {"optimizer": {"type": "ZeroOneAdam",
                              "params": {"lr": 1e-3}}},
    "sparse_gradients": {"sparse_gradients": True},
    "checkpoint_in_cpu": {"activation_checkpointing": {
        "cpu_checkpointing": True}},
}


@pytest.mark.parametrize("case", list(_REFUSED_CONFIGS)
                         + ["moe", "generate", "serving"])
def test_unported_beside_model_names_a7c(case):
    """What tensor parallelism does not run beside yet raises
    NotImplementedError naming ROADMAP A7c, before anything falls back to
    model 1: the engine's check of the config at model > 1
    (``_refuse_beside_model``), MoE blocks in ``set_tensor_parallel``,
    and generation and serving of a model holding its rank's shards."""
    from types import SimpleNamespace

    from deepspeed_tpu_torch.models.generation import generate
    from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
    from deepspeed_tpu_torch.runtime.engine import _refuse_beside_model
    from deepspeed_tpu_torch.serving import InferenceEngine

    rank0 = SimpleNamespace(size=2, rank=0)
    with pytest.raises(NotImplementedError, match="A7c"):
        if case in _REFUSED_CONFIGS:
            raw = dict(W.ds_config(1, 0, 1), **_REFUSED_CONFIGS[case])
            _refuse_beside_model(raw, DeepSpeedConfig(raw, world_size=1),
                                 W.sp_model("gpt2"))
        elif case == "moe":
            W.sp_model("gpt2", moe_num_experts=4).set_tensor_parallel(rank0)
        else:
            m = W.sp_model("gpt2")
            m.set_tensor_parallel(rank0)
            if case == "generate":
                generate(m, None, np.zeros((1, 4), np.int64), 2,
                         device="cpu")
            else:
                InferenceEngine(m, device="cpu")


def test_mfu_counts_the_whole_model_over_every_device(world):
    """The MFU report at {"data": 2, "model": 2}: the whole model's
    parameters, the tokens of the global batch, four devices, and per
    rank half the hardware FLOPs of one process's step (every matmul and
    attention of GPT-2 is split over the model line)."""
    mfu = world("tp_w4")[0]["mfu"]["mfu"]
    eng = _port_engine("gpt2", telemetry={"enabled": True})
    batches = W.sp_batches("gpt2", TP.SEED, 1, TP.GAS, 2 * W.MICRO)
    eng.train_batch(batch={k: v[0][:, :W.MICRO] for k, v in
                           batches.items()})
    one = eng.telemetry_report()["mfu"]
    assert mfu["n_devices"] == 4 and one["n_devices"] == 1
    assert mfu["n_params"] == one["n_params"] \
        == sum(p.numel() for p in W.sp_model("gpt2").parameters())
    assert mfu["tokens_per_step"] == 2 * one["tokens_per_step"]
    assert mfu["model_flops_per_step"] == 2 * one["model_flops_per_step"]
    assert mfu["hw_flops_per_step"] * 2 == one["hw_flops_per_step"]


def test_mpu_must_agree_with_the_mesh(clean_env):
    """An ``mpu`` (the topology's interface) is accepted when its sizes
    are the mesh's, else ValueError."""
    from deepspeed_tpu_torch.runtime.pipe.topology import (
        PipeModelDataParallelTopology, PipelineParallelGrid)

    grid = PipelineParallelGrid(PipeModelDataParallelTopology(1, 1, 1), 0)
    eng = deepspeed_tpu_torch.initialize(
        model=W.sp_model("gpt2"), config_params=W.ds_config(1, 0, 1),
        mpu=grid, device="cpu")[0]
    assert eng.mpu is grid and eng.mp_world_size == 1
    grid2 = PipelineParallelGrid(PipeModelDataParallelTopology(1, 2, 1), 0)
    with pytest.raises(ValueError, match="get_model_parallel_world_size"):
        deepspeed_tpu_torch.initialize(
            model=W.sp_model("gpt2"), config_params=W.ds_config(1, 0, 1),
            mpu=grid2, device="cpu")


@pytest.fixture
def clean_env(monkeypatch):
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT"):
        monkeypatch.delenv(key, raising=False)
