"""Autoregressive generation for GPT-2 with a KV cache.

Port of deepspeed_tpu/models/generation.py. The decode loop is a Python
loop of device work with no host round-trip until the tokens are returned:
the prompt is consumed by ONE batched causal forward (prefill) that seeds
a preallocated (L, B, H, S_max, D) cache, then each step runs one token
through every block against the cache, written in place.

The decode surfaces (``generate``, ``generate_beam`` and the serving
engine's paged decode and prefill, deepspeed_tpu_torch/serving/engine.py)
share one parameter view and one dtype policy, the reference's:

- ``decode_params`` reads the GPT-2's fp32 parameters (the model's own, a
  state_dict, or the JAX package's tree in either layout) and casts the
  dense kernels and biases, the embeddings and the tied head to the
  compute dtype ONCE (the reference casts them at each use); LayerNorm
  keeps its fp32 scale and bias;
- ``_ln`` normalises in fp32 and casts back; ``_dense`` runs in the
  compute dtype; ``_attn_core`` takes the scores from fp32 copies of q and
  the keys (a compute-dtype product would round them), scales them by
  D**-0.5 after the product, masks with -1e30, softmaxes in fp32 and casts
  the probabilities to the compute dtype before P.V; ``_lm_logits`` takes
  the head product in the compute dtype, drops the pad columns, then casts
  to fp32; GELU is the tanh form;
- an MoE block (``moe``) keeps its router kernel (M, E) in fp32 and its
  expert stacks in the compute dtype; ``_moe_ffn`` gates as the training
  layer does (fp32 router product and softmax, combine and dispatch
  rounded to the compute dtype).

Sampling draws are a pure function of (seed, absolute position, token id):
Gumbel noise from a counter hash, added to the filtered logits, argmax. No
torch RNG state is read or advanced. No torch RNG reproduces
``jax.random.categorical``, so sampled tokens agree with the reference
only through greedy decoding and through the support of the draws after
the top-k and top-p filters (ROADMAP C-w6).
"""
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from deepspeed_tpu_torch.models.convert import (gpt2_moe_block,
                                                params_from_jax)
from deepspeed_tpu_torch.moe.sharded_moe import top_k_gating
from deepspeed_tpu_torch.ops.transformer.flash_attention import (_M32,
                                                                 _mix32,
                                                                 _mul32)

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------
def _is_jax_tree(params):
    return isinstance(params.get("ln_f"), dict)


def decode_params(model, params=None, device=None):
    """The decode surfaces' view of a GPT-2's parameters on ``device``:
    ``{"wte", "wpe", "ln_f", "blocks": [{"ln_1", "attn": {"c_attn",
    "c_proj"}, "ln_2", "mlp": {"c_fc", "c_proj"}}]}`` with LayerNorm
    ``{"scale", "bias"}`` in fp32 and dense ``{"kernel" (in, out), "bias"}``,
    ``wte`` (padded vocab rows kept) and ``wpe`` in ``model.config.dtype``;
    an MoE block has ``"moe": {"router": {"kernel"}, "experts": {"w_in",
    "b_in", "w_out", "b_out"}}`` in place of ``"mlp"``, the router kernel
    (M, E) in fp32 and the full expert stacks in the compute dtype.

    ``params``: None (the model's own parameters), a state_dict of
    ``GPT2Model`` names, or the JAX package's parameter tree (nested dicts
    of numpy arrays, unrolled or scan-stacked). The weights must be fp32:
    the training engine's module at bf16/fp16 holds the compute-dtype
    copy, whose LayerNorm weights are rounded; pass its fp32 master,
    ``dict(zip(engine.param_names, engine.master))``, instead."""
    cfg = model.config
    if params is None:
        sd = {k: v.detach() for k, v in model.state_dict().items()}
    elif _is_jax_tree(params):
        sd = params_from_jax(params, cfg)
    else:
        sd = {k: torch.as_tensor(v).detach() for k, v in params.items()}
    for name, t in sd.items():
        if t.dtype != torch.float32:
            raise ValueError(
                f"decode weights must be fp32, {name} is {t.dtype}: pass "
                f"the fp32 master (dict(zip(engine.param_names, "
                f"engine.master))), not the engine's compute-dtype module")
    dt = cfg.dtype

    def norm(prefix):
        return {"scale": sd[f"{prefix}.weight"].to(device),
                "bias": sd[f"{prefix}.bias"].to(device)}

    def dense(prefix):
        return {"kernel": sd[f"{prefix}.weight"].t().to(device, dt)
                .contiguous(),
                "bias": sd[f"{prefix}.bias"].to(device, dt)}

    blocks = []
    for i in range(cfg.n_layer):
        p = f"h.{i}"
        block = {
            "ln_1": norm(f"{p}.ln_1"),
            "attn": {"c_attn": dense(f"{p}.attn.c_attn"),
                     "c_proj": dense(f"{p}.attn.c_proj")},
            "ln_2": norm(f"{p}.ln_2")}
        if gpt2_moe_block(cfg, i):
            block["moe"] = {
                "router": {"kernel": sd[f"{p}.moe.router.weight"].t()
                           .to(device).contiguous()},
                "experts": {n: sd[f"{p}.moe.experts.{n}"].to(device, dt)
                            for n in ("w_in", "b_in", "w_out", "b_out")}}
        else:
            block["mlp"] = {"c_fc": dense(f"{p}.mlp.c_fc"),
                            "c_proj": dense(f"{p}.mlp.c_proj")}
        blocks.append(block)
    return {"wte": sd["wte"].to(device, dt).contiguous(),
            "wpe": sd["wpe"].to(device, dt).contiguous(),
            "ln_f": norm("ln_f"), "blocks": blocks}


# ---------------------------------------------------------------------------
# the decode math
# ---------------------------------------------------------------------------
def _ln(x, p, eps):
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mu).square().mean(dim=-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"] + p["bias"]).to(x.dtype)


def _dense(x, p):
    return x @ p["kernel"] + p["bias"]


def _split_heads(t, B, T, H, D):
    return t.reshape(B, T, H, D).transpose(1, 2)       # (B, H, T, D)


def _attn_core(q, keys, values, valid, p, out_dtype):
    """Masked attention shared by every decode surface: the contiguous
    KV cache here, the causal prefill, and the serving engine's paged
    pool. q/keys/values: (B, H, Q, D) and (B, H, K, D); ``valid``
    broadcasts against the (B, H, Q, K) score tensor. Scores accumulate
    in fp32 and masked positions score -1e30, which softmax turns into
    exact zeros."""
    B, H, Q, D = q.shape
    s = torch.matmul(q.float(), keys.float().transpose(-1, -2)) \
        * (D ** -0.5)
    s = torch.where(valid, s, NEG_INF)
    probs = torch.softmax(s, dim=-1).to(out_dtype)
    y = torch.matmul(probs, values)                    # (B, H, Q, D)
    y = y.transpose(1, 2).reshape(B, Q, H * D)
    return _dense(y, p["c_proj"])


def _moe_ffn(x, mp, cfg):
    """The MoE feed-forward of one block at decode: the training layer's
    dense top-k gating and stacked-expert products (moe/sharded_moe.py),
    without jitter, at ``cfg.moe_capacity_factor`` as the eval forward of a
    GPT-2 block gates. x: (B, T, M).

    Capacity: prefill gates the whole prompt per batch row as the training
    forward does; decode gates ONE token per step at capacity k (it takes
    at most one slot of each chosen expert, so nothing drops, and the
    min_capacity floor would only oversize the expert products), so a
    decoded token never competes with its predecessors for slots. The same
    as the training forward wherever that drops nothing."""
    dtype = x.dtype
    logits = x.float() @ mp["router"]["kernel"]          # (B, T, E)
    cap = cfg.moe_top_k if x.shape[1] == 1 else None
    combine, dispatch, _, _ = top_k_gating(
        logits, k=cfg.moe_top_k, capacity=cap,
        capacity_factor=cfg.moe_capacity_factor)
    ex = mp["experts"]
    E = cfg.moe_num_experts
    d = torch.einsum("gsec,gsm->egcm", dispatch.to(dtype), x)
    B, C = d.shape[1], d.shape[2]
    d = d.reshape(E, B * C, -1)
    h = torch.bmm(d, ex["w_in"]) + ex["b_in"][:, None, :]
    h = F.gelu(h, approximate="tanh")
    y = torch.bmm(h, ex["w_out"]) + ex["b_out"][:, None, :]
    y = y.reshape(E, B, C, -1)
    # dropped tokens get zero here and ride the residual, as in training
    return torch.einsum("egcm,gsec->gsm", y, combine.to(dtype))


def _ffn(x, bp, cfg=None):
    """The block's dense MLP, or its MoE layer (``cfg`` needed)."""
    if "moe" in bp:
        return _moe_ffn(x, bp["moe"], cfg)
    mp = bp["mlp"]
    return _dense(F.gelu(_dense(x, mp["c_fc"]), approximate="tanh"),
                  mp["c_proj"])


def _attn_decode(x, p, cache_k, cache_v, pos, cfg):
    """One-token attention against the cache. x: (B, 1, E); cache_k/v:
    (B, H, S_max, D), written in place at ``pos`` (an int)."""
    B = x.shape[0]
    H, D = cfg.n_head, cfg.head_dim
    q, k, v = _dense(x, p["c_attn"]).split(cfg.n_embd, dim=-1)
    q, k, v = (_split_heads(t, B, 1, H, D) for t in (q, k, v))
    cache_k[:, :, pos] = k[:, :, 0]
    cache_v[:, :, pos] = v[:, :, 0]
    valid = torch.arange(cache_k.shape[2], device=x.device) <= pos
    return _attn_core(q, cache_k, cache_v, valid[None, None, None, :], p,
                      x.dtype)


def _block_decode(x, bp, ck, cv, pos, cfg):
    eps = cfg.layer_norm_epsilon
    x = x + _attn_decode(_ln(x, bp["ln_1"], eps), bp["attn"], ck, cv, pos,
                         cfg)
    return x + _ffn(_ln(x, bp["ln_2"], eps), bp, cfg)


def _attn_prefill(x, p, cfg):
    """Causal attention over the whole prompt; returns (out, k, v) with
    k/v shaped (B, H, S0, D) for cache seeding."""
    B, S, _ = x.shape
    H, D = cfg.n_head, cfg.head_dim
    q, k, v = _dense(x, p["c_attn"]).split(cfg.n_embd, dim=-1)
    q, k, v = (_split_heads(t, B, S, H, D) for t in (q, k, v))
    mask = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    return _attn_core(q, k, v, mask[None, None], p, x.dtype), k, v


def _lm_logits(params, cfg, xe):
    """Tied LM head over (B, E) final hidden states in the compute dtype,
    the pad columns dropped so sampling never picks a pad id, then fp32."""
    logits = xe @ params["wte"].t()
    return logits[:, :cfg.vocab_size].float()


def _prefill(params, cfg, tokens):
    """One batched forward over the (B, S0) prompt: the logits at the last
    prompt position and per-layer K/V (L, B, H, S0, D) for cache seeding."""
    S0 = tokens.shape[1]
    eps = cfg.layer_norm_epsilon
    x = params["wte"][tokens] + params["wpe"][:S0][None]
    ks, vs = [], []
    for bp in params["blocks"]:
        a, k, v = _attn_prefill(_ln(x, bp["ln_1"], eps), bp["attn"], cfg)
        x = x + a
        x = x + _ffn(_ln(x, bp["ln_2"], eps), bp, cfg)
        ks.append(k)
        vs.append(v)
    x = _ln(x, params["ln_f"], eps)
    return _lm_logits(params, cfg, x[:, -1]), torch.stack(ks), \
        torch.stack(vs)


def _forward_token(params, cfg, token, pos, caches_k, caches_v):
    """Embed one token per row, run all blocks against the cache (written
    in place), return the logits. token: (B,) int; pos: int; caches:
    (L, B, H, S_max, D)."""
    x = params["wte"][token][:, None, :] + params["wpe"][pos][None, None, :]
    for i, bp in enumerate(params["blocks"]):
        x = _block_decode(x, bp, caches_k[i], caches_v[i], pos, cfg)
    x = _ln(x, params["ln_f"], cfg.layer_norm_epsilon)
    return _lm_logits(params, cfg, x[:, 0]), caches_k, caches_v


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------
def _gumbel(seeds, pos, vocab):
    """(N, vocab) Gumbel noise, each element a pure function of its row's
    (seed, absolute position) and the token id: a counter hash to a
    uniform in (0, 1), then -log(-log(u))."""
    cols = torch.arange(vocab, device=seeds.device, dtype=torch.int64)
    s = _mix32((_mix32(seeds.long() & _M32) + (pos.long() & _M32)) & _M32)
    h = _mix32(s[:, None] ^ _mul32(cols, 0x27D4EB2F)[None, :])
    u = ((h >> 8).float() + 0.5) * (1.0 / (1 << 24))
    return -torch.log(-torch.log(u))


def _sample(logits, seeds, pos, temperature, top_k, top_p=0.0):
    """Next token per row of (N, V) fp32 logits: argmax at temperature 0,
    else a draw from the temperature-scaled distribution after the top-k
    and top-p filters (the reference's, token for token), keyed on each
    row's (seed, position)."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    logits = logits / temperature
    use_k = top_k and top_k < logits.shape[-1]
    use_p = top_p and top_p < 1.0
    if use_k or use_p:
        # one descending sort serves both filters
        sorted_desc = torch.sort(logits, dim=-1, descending=True).values
        if use_k:
            kth = sorted_desc[:, top_k - 1:top_k]
            logits = torch.where(logits < kth, NEG_INF, logits)
        if use_p:
            # nucleus: the smallest prefix of the sorted distribution whose
            # EXCLUSIVE cumulative mass is below top_p (the top token
            # always survives); with top_k active, within the top-k set
            if use_k:
                sorted_desc = torch.where(sorted_desc < kth, NEG_INF,
                                          sorted_desc)
            probs = torch.softmax(sorted_desc, dim=-1)
            exclusive = torch.cumsum(probs, dim=-1) - probs
            keep = exclusive < top_p
            cutoff = torch.where(keep, sorted_desc, float("inf")) \
                .amin(dim=-1, keepdim=True)
            logits = torch.where(logits >= cutoff, logits, NEG_INF)
    return torch.argmax(logits + _gumbel(seeds, pos, logits.shape[-1]),
                        dim=-1)


def _row_seeds(seed, batch, device):
    """The sampling seed of each row of a batch drawn with ``seed``: row 0
    takes ``seed`` itself (so row 0 of ``generate`` draws what the serving
    engine draws for a request submitted with that seed)."""
    rows = torch.arange(batch, device=device, dtype=torch.int64)
    return (int(seed) + _mul32(rows, 0x9E3779B9)) & _M32


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------
def _device_of(device):
    from deepspeed_tpu_torch.runtime.engine import resolve_device

    return resolve_device(device)


@torch.no_grad()
def generate(model, params, input_ids, max_new_tokens: int,
             temperature: float = 0.0, top_k: Optional[int] = None,
             top_p: float = 0.0, rng: Optional[int] = None,
             num_beams: int = 1, eos_token_id: Optional[int] = None, *,
             device=None, return_logits: bool = False):
    """Generate ``max_new_tokens`` continuations of ``input_ids`` (B, S0)
    with ``model`` (a ``GPT2Model``) and ``params`` (None for the model's
    own; see ``decode_params``). temperature 0 = greedy; top_k / top_p
    (nucleus) filter the sampling distribution and compose (top_k first);
    ``rng`` is the int seed of the draws (0 when None); num_beams > 1
    switches to beam search. Rows that emit ``eos_token_id`` repeat it at
    every later position (the sequence keeps its fixed length).

    Runs on ``device`` (``cuda`` by default; ``"cpu"`` on request).
    Returns the (B, S0 + max_new_tokens) int32 numpy array, and with
    ``return_logits`` also the fp32 logits that chose each new token,
    (B, max_new_tokens, vocab_size)."""
    cfg = model.config
    if getattr(model, "tp_group", None) is not None:
        raise NotImplementedError("generation with a tensor-parallel model "
                                  "(mesh model > 1) is not ported yet "
                                  "(ROADMAP A7c)")
    ids_np = np.asarray(input_ids, np.int32)
    if max_new_tokens <= 0:
        return ids_np
    # a sign/range bug here would otherwise mask EVERY logit and emit
    # plausible-shaped garbage (token 0 forever) with no error
    assert 0.0 <= (top_p or 0.0) <= 1.0, f"top_p must be in [0, 1]: {top_p}"
    assert top_k is None or top_k >= 0, f"top_k must be >= 0: {top_k}"
    assert temperature >= 0.0, f"temperature must be >= 0: {temperature}"
    if num_beams > 1:
        assert temperature == 0.0 and not top_k and not top_p \
            and rng is None, \
            "beam search is deterministic; drop temperature/top_k/top_p/rng"
        assert eos_token_id is None, \
            "beam search is fixed-length; eos_token_id is not supported " \
            "with num_beams > 1 (length-normalized eos-aware scoring is a " \
            "different search)"
        return generate_beam(model, params, ids_np, max_new_tokens,
                             num_beams=num_beams, device=device)
    B, S0 = ids_np.shape
    S_max = S0 + max_new_tokens
    assert S_max <= cfg.n_positions, \
        f"{S_max} exceeds n_positions={cfg.n_positions}"
    device = _device_of(device)
    w = decode_params(model, params, device)
    ids = torch.as_tensor(ids_np, device=device).long()
    L, H, D = cfg.n_layer, cfg.n_head, cfg.head_dim
    caches_k = torch.zeros(L, B, H, S_max, D, dtype=cfg.dtype, device=device)
    caches_v = torch.zeros_like(caches_k)
    seeds = _row_seeds(0 if rng is None else rng, B, device)
    temperature, top_k, top_p = float(temperature), int(top_k or 0), \
        float(top_p or 0.0)

    def pick(logits, pos):
        return _sample(logits, seeds, torch.full_like(seeds, pos),
                       temperature, top_k, top_p)

    logits, pk, pv = _prefill(w, cfg, ids)
    caches_k[:, :, :, :S0] = pk
    caches_v[:, :, :, :S0] = pv
    tok = pick(logits, S0 - 1)
    done = tok == eos_token_id if eos_token_id is not None \
        else torch.zeros_like(tok, dtype=torch.bool)
    out, all_logits = [tok], [logits]
    # decode steps consume tokens at positions S0 .. S_max-2
    for pos in range(S0, S_max - 1):
        logits, _, _ = _forward_token(w, cfg, tok, pos, caches_k, caches_v)
        nxt = pick(logits, pos)
        if eos_token_id is not None:
            # finished rows keep emitting eos; the cache still advances
            nxt = torch.where(done, eos_token_id, nxt)
            done = done | (nxt == eos_token_id)
        out.append(nxt)
        all_logits.append(logits)
        tok = nxt
    new = torch.stack(out, dim=1).cpu().numpy().astype(np.int32)
    seq = np.concatenate([ids_np, new], axis=1)
    if return_logits:
        return seq, torch.stack(all_logits, dim=1).cpu().numpy()
    return seq


@torch.no_grad()
def generate_beam(model, params, input_ids, max_new_tokens: int,
                  num_beams: int = 4, *, device=None):
    """Beam-search decode: the highest-log-probability continuation among
    ``num_beams`` beams per batch row. input_ids: (B, S0) int; returns the
    (B, S0 + max_new_tokens) int32 numpy array. Fixed-length search (no
    eos); beams live as a (B*W) batch over the greedy cache, and each
    step's top-W reselection reorders the caches along the beam axis.
    num_beams=1 is exactly greedy decode."""
    cfg = model.config
    ids_np = np.asarray(input_ids, np.int32)
    if max_new_tokens <= 0:
        return ids_np
    B, S0 = ids_np.shape
    W = int(num_beams)
    assert W >= 1
    assert W <= cfg.vocab_size, \
        f"num_beams={W} exceeds vocab_size={cfg.vocab_size}; " \
        f"top-k reselection cannot produce more beams than tokens"
    S_max = S0 + max_new_tokens
    assert S_max <= cfg.n_positions, \
        f"{S_max} exceeds n_positions={cfg.n_positions}"
    T = max_new_tokens
    device = _device_of(device)
    w = decode_params(model, params, device)
    ids = torch.as_tensor(ids_np, device=device).long()
    logits0, pk, pv = _prefill(w, cfg, ids)             # (B, V), (L,B,H,S0,D)
    logp0 = torch.log_softmax(logits0, dim=-1)
    V = logp0.shape[-1]
    # seed beams with the prompt's top-W continuations
    scores, first = torch.topk(logp0, W, dim=-1)        # (B, W)

    def tile(c):
        # (L, B*W, H, S_max, D), beam-major within batch
        c = F.pad(c, (0, 0, 0, S_max - S0))
        return c.repeat_interleave(W, dim=1)

    ck, cv = tile(pk), tile(pv)
    toks = torch.zeros(B, W, T, dtype=torch.int64, device=device)
    toks[:, :, 0] = first
    prev = first
    rows = torch.arange(B, device=device)[:, None] * W
    for pos in range(S0, S_max - 1):
        logits, ck, cv = _forward_token(w, cfg, prev.reshape(B * W), pos,
                                        ck, cv)         # (B*W, V)
        logp = torch.log_softmax(logits, dim=-1).reshape(B, W, V)
        cand = scores[:, :, None] + logp                # (B, W, V)
        scores, idx = torch.topk(cand.reshape(B, W * V), W, dim=-1)
        parent = idx // V                               # (B, W)
        nxt = idx % V
        # reorder beam state by parent: tokens-so-far and KV caches
        toks = torch.take_along_dim(toks, parent[:, :, None], dim=1)
        toks[:, :, pos - S0 + 1] = nxt
        gather = (rows + parent).reshape(-1)
        ck = ck.index_select(1, gather)
        cv = cv.index_select(1, gather)
        prev = nxt
    best = torch.argmax(scores, dim=-1)                 # (B,)
    out = toks[torch.arange(B, device=device), best]    # (B, T)
    return np.concatenate(
        [ids_np, out.cpu().numpy().astype(np.int32)], axis=1)
