"""Ulysses sequence parallelism of the PyTorch port (parallel/ulysses.py,
parallel/mesh.py's process grid, the engine at mesh ``seq`` > 1), in gloo
worlds of 4 and 2 ranks on the CPU (tests/torch_sp_worlds.py), held
against the JAX package on its 8 virtual CPU devices, fp32, inputs from
numpy seeds.

- The function: ``ulysses_attention`` over the world as one seq group
  against ``make_ulysses_attention`` at the same N, forward and the
  gradients against ``jax.grad``, causal and not, N in {2, 4}: rtol 2e-5,
  atol 2e-5 (both sides are the same fp32 attention after an exact
  reshard; the JAX package's own test holds Ulysses to dense attention at
  2e-4). Its all-to-alls counted: two forward, two backward.
- Dropout 0.1 under Ulysses equals one process's dropout over all heads
  (the flash kernels' plain versions, whose hash indexes a rank's heads
  globally): rtol 1e-5, atol 1e-6.
- The engine: GPT-2 at {"seq": 4} (ZeRO 2) and {"data": 2, "seq": 2}
  (ZeRO 0 and 2), BERT at {"data": 2, "seq": 2} (ZeRO 1), dense and
  block-sparse, 5 Adam steps against ``deepspeed_tpu.initialize`` at the
  same mesh on the same global batches: losses at rtol 2e-5, masters at
  tests/test_torch_zero.py's rtol 1e-4, atol 1e-5 (under the JAX
  package's own sp-versus-dp rtol 2e-4). The counted collectives are the
  comm report's (the JAX engine's) plus the seq axis's, which the report
  omits and the JAX program posts (ROADMAP C-w14). The analytic memory,
  the program registry and the lint.
- The port against itself: GPT-2 with dropout 0.1 at {"seq": 2} equals
  the port at seq 1 (rtol 1e-5).
- Checkpoints: a seq-2 tag loads at seq 1 and into the JAX engine, and
  the JAX engine's seq-2 tag into the port at seq 2.
- Refusals: MoE under seq, heads Ulysses cannot divide, a sequence the
  axis does not divide, and ``model`` beside ``seq``.
- ZeRO stage 3 beside the other axes (3 steps): GPT-2 at {"data": 2,
  "seq": 2} (the scheduled gathers disarm at seq > 1) equals its stage 2
  bit for bit; BERT, dense and block-sparse, at {"data": 2}: the implicit
  path equals stage 2 bit for bit, the scheduled int8 gathers stay within
  1e-3 of stage 2's losses (measured 5.8e-4: BERT's small LayerNorm and
  bias leaves code in blocks of their own).
"""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
import torch_sp_worlds as SP
import torch_zero_worker as W
from deepspeed_tpu.runtime import comm_accounting as jca
from deepspeed_tpu.runtime.checkpoint_utils import npz_dict_to_leaves
from deepspeed_tpu.runtime.engine import _first_micro
from deepspeed_tpu_torch.models.convert import params_from_jax
from deepspeed_tpu_torch.ops.transformer import flash_attention as tfa

FN_RTOL = FN_ATOL = 2e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ULYSSES_FNS = ["ulysses_n4_causal", "ulysses_n4_full", "ulysses_n2_causal"]
ULYSSES_ENGINES = [c for c in SP.ENGINE_CASES if "ring" not in c]


@pytest.fixture(scope="session")
def world(tmp_path_factory):
    return W.session_worlds(tmp_path_factory, SP.WORLDS)


# ---------------------------------------------------------------------------
# the function
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", ULYSSES_FNS)
def test_ulysses_matches_jax(world, case):
    n, mode, shape, seed, causal, _, _ = SP.ATTENTION_CASES[case]
    got = SP.gathered(world, case, n)
    want = SP.jax_function(mode, n, shape, seed, causal)
    SP.assert_function_close(got, want, FN_RTOL, FN_ATOL, case)


@pytest.mark.parametrize("case", ULYSSES_FNS)
def test_ulysses_posts_two_all_to_alls_each_way(world, case):
    """q, k, v in one stacked all-to-all and the output in another, and
    their backwards: each rank sends all but its own chunk."""
    n, _, (b, h, s, d), *_ = SP.ATTENTION_CASES[case]
    for rank in world(f"sp_w{n}"):
        comm = rank[case]["comm"]
        assert comm["calls"] == {"all-to-all": 4}
        chunk = b * h * (s // n) * d
        want = {"sp_a2a:qkv": 3 * chunk, "sp_a2a:out": chunk,
                "sp_a2a:out_bwd": chunk, "sp_a2a:qkv_bwd": 3 * chunk}
        assert {c["name"]: c["elements"] for c in comm["collectives"]} \
            == want
        for c in comm["collectives"]:
            assert c["bytes_per_step"] == jca.all_to_all_bytes(
                c["elements"], 4, n)


@pytest.mark.parametrize("n", [2, 4])
def test_ulysses_dropout_is_one_process_over_all_heads(world, n):
    """Each rank's heads draw their rows of the whole model's dropout
    masks (head offset r * H/N of H): the joined output and gradients
    equal one process's flash attention over all heads with the same
    seed."""
    case = f"ulysses_n{n}_dropout"
    _, _, shape, seed, causal, _, (rate, gseed) = SP.ATTENTION_CASES[case]
    q, k, v, do = (torch.as_tensor(x).requires_grad_(i < 3) for i, x in
                   enumerate(SP.attention_inputs(shape, seed)))
    dseed = torch.randint(0, 2 ** 31 - 1, (1,), dtype=torch.int32,
                          generator=torch.Generator().manual_seed(gseed))
    out = tfa.flash_attention(q, k, v, causal=causal, dropout_rate=rate,
                              dropout_seed=dseed)
    out.backward(do)
    want = {"out": out.detach().numpy(),
            **{f"d{x}": t.grad.numpy() for x, t in zip("qkv", (q, k, v))}}
    got = SP.gathered(world, case, n)
    SP.assert_function_close(got, want, 1e-5, 1e-6, case)
    # the masks really differ between heads: rank 0's head 0 is not
    # rank 1's head 0
    keep = tfa.dropout_keep_mask(int(dseed), 2 * shape[1], 0, 8, 0, 8, rate,
                                 "cpu")
    assert not torch.equal(keep[0], keep[shape[1] // n])


def test_head_offset_zero_is_the_plain_hash():
    """Offset 0 of all heads indexes b * H + h: the masks of every earlier
    launch, bit for bit; a rank's heads index their global rows."""
    full = tfa.dropout_keep_mask(7, 8, 0, 16, 0, 16, 0.3, "cpu")
    same = tfa.dropout_keep_mask(7, 8, 0, 16, 0, 16, 0.3, "cpu",
                                 num_heads=4, head_offset=0, total_heads=4)
    assert torch.equal(full, same)
    # batch 2 x heads 2..3 of 4: rows (b * 4 + 2, b * 4 + 3)
    part = tfa.dropout_keep_mask(7, 4, 0, 16, 0, 16, 0.3, "cpu",
                                 num_heads=2, head_offset=2, total_heads=4)
    assert torch.equal(part, full[[2, 3, 6, 7]])


# ---------------------------------------------------------------------------
# the engine against the JAX engine
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", ULYSSES_ENGINES)
def test_engine_matches_jax_at_the_same_mesh(world, case):
    SP.assert_engine_matches_jax(world, case)


@pytest.mark.parametrize("case", ULYSSES_ENGINES)
def test_counted_collectives_are_the_report_and_the_seq_axis(world, case):
    SP.assert_counted_collectives(world, case)


def test_jax_program_posts_the_seq_axis_its_report_omits():
    """ROADMAP C-w14, read from the JAX program at {"seq": 4}: its
    compiled step posts all-to-alls (the Ulysses flips) and all-reduces
    (the gradients over ``seq``), while ``comm_volume_report`` prices
    only the data axis: at data 1, all-reduces of 0 bytes and no
    all-to-all."""
    sys.path.insert(0, REPO)
    from tools.graftlint import hlo_contracts as hc

    jeng = SP.jax_run("gpt2_s4_ulysses")["engine"]
    ops = [op.op for name in jeng.program_registry.names()
           for op in hc.collective_ops(jeng.program_registry.get(name).hlo())]
    assert "all-to-all" in ops and "all-reduce" in ops
    report = jeng.comm_volume_report()
    assert {c["op"] for c in report["collectives"]} == {"all-reduce"}
    assert report["total_bytes_per_step"] == 0


@pytest.mark.parametrize("case", ["gpt2_s4_ulysses", "gpt2_d2s2_z0"])
def test_analytic_memory_equals_the_jax_engine(world, case):
    """Per device, byte for byte: the parameters are replicated over
    ``seq``, so each rank holds what a rank of the data axis alone holds
    (at fp32 and ZeRO 0, or data 1, the master is the parameters on both
    sides, ROADMAP C-w10)."""
    jeng = SP.jax_run(case)["engine"]
    want = dict(jeng._analytic_memory_components()["components"])
    for rank in world("sp_w4"):
        got = rank[case]["memory"]["components"]
        assert {k: got[k] for k in want} == want


def test_program_registry_is_the_jax_engines_and_the_lint_is_clean(world):
    jreg = SP.jax_run("gpt2_s4_ulysses")["engine"].program_registry
    jsum = jreg.summary()
    for rank in world("sp_w4"):
        got = rank["gpt2_s4_ulysses"]
        assert got["lint"] == []
        assert set(got["contracts"]) == set(jreg.names())
        for name, contract in got["contracts"].items():
            want = dict(jsum[name]["contract"])
            want.pop("donates", None)
            have = dict(contract)
            have.pop("donates", None)
            assert have == want, name


# ---------------------------------------------------------------------------
# the port against itself, checkpoints, refusals
# ---------------------------------------------------------------------------
def _port_seq1(steps, model=None, stage=0, offload=False):
    config = W.ds_config(1, stage, SP.GAS, lr=SP.LR, offload=offload)
    module = W.sp_model("gpt2", **(model or {}))
    eng = deepspeed_tpu_torch.initialize(model=module, config_params=config,
                                         device="cpu")[0]
    eng.load_module_state_dict(params_from_jax(SP.jax_init("gpt2"),
                                               module.config))
    losses = [eng.train_batch(batch=SP.global_batch("gpt2", s, 1)).item()
              for s in range(steps)]
    return eng, losses


def test_dropout_at_seq2_is_the_port_at_seq1(world):
    """Dropout 0.1 everywhere (embeddings, attention, residuals): each
    rank draws the whole sequence's masks and keeps its chunk's, and the
    attention's hash indexes its heads globally, so seq 2 trains as seq 1
    does, to fp32 summation order."""
    eng, losses = _port_seq1(3, {"dropout": 0.1})
    want = W._full_master(eng)
    for rank in world("sp_w2"):
        got = rank["dropout"]
        np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
        W.assert_master_close(got["master"], want, 1e-5, 1e-6, 3, SP.LR,
                              "dropout")


def test_offload_at_seq2_is_the_port_at_seq1(world):
    """ZeRO-Offload (stage 2) takes the gradients summed over the seq
    group: the host Adam at seq 2 trains as at seq 1, to fp32 summation
    order."""
    eng, losses = _port_seq1(3, stage=2, offload=True)
    want = W._full_master(eng)
    for rank in world("sp_w2"):
        got = rank["offload"]
        np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
        W.assert_master_close(got["master"], want, 1e-5, 1e-6, 3, SP.LR,
                              "offload")


def test_mfu_counts_the_ranks_share_of_the_step(world):
    """Armed at {"seq": 2}: the model FLOPs are the global step's 6ND over
    both devices, as the JAX engine counts them (every parameter, the
    global batch's tokens), and each rank's hardware FLOPs, counted by
    its own replay, sum to the step's at seq 1: a rank computes its
    chunk's tokens (the LM head the positions that have a next label) and
    its half of the heads' attention over the whole sequence."""
    config = dict(W.ds_config(1, 2, SP.GAS, lr=SP.LR),
                  telemetry={"enabled": True})
    eng = deepspeed_tpu_torch.initialize(model=W.sp_model("gpt2"),
                                         config_params=config,
                                         device="cpu")[0]
    for s in range(2):
        eng.train_batch(batch=SP.global_batch("gpt2", s, 1))
    one = eng.telemetry_report()["mfu"]
    ranks = [rank["save"]["mfu"] for rank in world("sp_w2")]
    for got in ranks:
        assert got["n_devices"] == 2
        assert got["n_params"] == one["n_params"]
        assert got["tokens_per_step"] == one["tokens_per_step"] \
            == SP.GAS * W.MICRO * W.SEQ
        assert got["model_flops_per_step"] == one["model_flops_per_step"]
    assert sum(got["hw_flops_per_step"] for got in ranks) \
        == one["hw_flops_per_step"]


def test_seq2_tag_loads_at_seq1_and_into_the_jax_engine(world, tmp_path):
    import deepspeed_tpu

    import pickle

    saved = world("sp_w2")[0]["save"]
    want = saved["master"]
    with open(os.path.join(saved["saved"], "metadata.pkl"), "rb") as f:
        topology = pickle.load(f)["topology"]
    assert topology["mesh"] == {"pipe": 1, "data": 1, "seq": 2, "model": 1}
    assert topology["sp"] == 2
    eng = deepspeed_tpu_torch.initialize(
        model=W.sp_model("gpt2"), config_params=W.ds_config(1, 2, SP.GAS),
        device="cpu")[0]
    eng.load_checkpoint(os.path.dirname(saved["saved"]))
    assert eng.global_steps == 2
    for name, m in W._full_master(eng).items():
        np.testing.assert_array_equal(m, want[name])
    jeng = SP.jax_engine("gpt2", {"data": 1}, 2)
    jeng._ensure_state(_first_micro(SP.global_batch("gpt2", 0, 1)))
    jeng.load_checkpoint(os.path.dirname(saved["saved"]))
    assert jeng.global_steps == 2
    params = jax.tree_util.tree_map(np.asarray,
                                    jax.device_get(jeng.state.params))
    got = params_from_jax(params, W.sp_model("gpt2").config)
    for name, t in got.items():
        np.testing.assert_array_equal(t.numpy(), want[name])


def test_jax_seq2_tag_loads_into_the_port_at_seq2(world):
    got = world("sp_w2")[0]["load_jax"]
    assert got["global_steps"] == 2
    with np.load(os.path.join(got["path"], "model_states.npz")) as npz:
        leaves = npz_dict_to_leaves(npz)
    assert len(leaves) == len(got["leaves"])
    # every leaf but the rng key, which a torch generator cannot continue
    for a, b in zip(got["leaves"][:-1], leaves[:-1]):
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      np.asarray(b, np.float32))


@pytest.mark.parametrize("case,exc,match", [
    ("moe", "NotImplementedError", "A15"),
    ("model_heads", "AssertionError", "divisible"),
    ("function_heads", "AssertionError", "use ring attention"),
    ("sequence", "ValueError", "not divisible by the 'seq' mesh axis"),
])
def test_seq_refusals(world, case, exc, match):
    got = world("sp_w2")[0]["refusals"][case]
    assert got is not None and got[0] == exc and match in got[1], got


@pytest.mark.parametrize("mesh,item", [
    ({"seq": 2, "model": 2}, "A7b"), ({"seq": 2, "pipe": 2}, "A12")])
def test_seq_beside_model_or_pipe_names_its_item(mesh, item):
    from deepspeed_tpu_torch.parallel.mesh import resolve_grid

    with pytest.raises(NotImplementedError, match=item):
        resolve_grid(mesh, 4)


def test_grid_is_the_jax_mesh_device_order():
    """Rank r holds JAX device r's coordinates: ((p*D + d)*N + s)*M + m."""
    from deepspeed_tpu.parallel.mesh import build_mesh
    from deepspeed_tpu_torch.parallel.mesh import ProcessGrid, resolve_grid

    shape = resolve_grid({"data": 2, "seq": 4}, 8)
    mesh = build_mesh({"data": 2, "seq": 4})
    ids = np.vectorize(lambda d: d.id)(mesh.devices)
    for r in range(8):
        c = ProcessGrid(shape, r).coords
        assert ids[c["pipe"], c["data"], c["seq"], c["model"]] == r
    grid = ProcessGrid(shape, 5)
    assert grid.line("seq") == [4, 5, 6, 7]
    assert grid.line("data") == [1, 5]


def test_new_modules_import_without_jax():
    code = ("import sys, deepspeed_tpu_torch.parallel.ulysses, "
            "deepspeed_tpu_torch.parallel.ring_attention; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'deepspeed_tpu')]; assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("kind", ["bert", "bert_sparse"])
def test_stage3_with_bert_at_dp2(world, kind):
    ranks = world("sp_w2")
    base, implicit = ranks[0][f"{kind}_d2_z2"], ranks[0][f"{kind}_d2_z3i"]
    sched = ranks[0][f"{kind}_d2_z3"]
    assert implicit["losses"] == base["losses"]
    for name, m in base["master"].items():
        assert np.array_equal(implicit["master"][name], m), name
    assert not implicit["stage3"]["armed"] and sched["stage3"]["armed"]
    np.testing.assert_allclose(sched["losses"], base["losses"], rtol=1e-3)


def test_stage3_beside_seq_is_stage2(world):
    ranks = world("sp_w4")
    for r in ranks:
        base, got = r["gpt2_d2s2_z2"], r["gpt2_d2s2_z3"]
        assert got["stage3"]["disarmed_by"] == ["seq=2"]
        assert got["losses"][:3] == base["losses"][:3]
