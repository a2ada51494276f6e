"""Continuous-batching inference engine over the paged KV pool.

Port of deepspeed_tpu/serving/engine.py. The dispatched surface is tiny
and FIXED-SHAPE:

- ONE decode step over all ``max_slots`` lanes and the full ``W * bs``
  key view, with per-slot page tables, positions and an active mask —
  requests joining, leaving, finishing or being evicted only change
  TENSOR CONTENTS, never shapes;
- a small family of length-bucketed prefill chunks (one per power-of-two
  bucket x final/non-final), so a long prompt is absorbed
  ``prefill_chunk`` tokens per step between decode steps.

Every dispatch reads one packed int32 host buffer (page tables,
positions, tokens, masks, seeds, the poison stream) copied to the device
in one transfer, records its signature in ``DispatchShapes`` (after
``warmup()`` churn adds none: the eager counterpart of the reference's
zero recompiles, and what a CUDA-graph capture of the decode step
needs), writes the pool tensors in place (their storage never moves) and
ends, where it samples, in ONE host fetch carrying the tokens and the
per-lane finiteness flags together: ``step()`` makes no other
device-to-host sync.

The decode math is models/generation.py's (``_attn_core``, ``_ln``,
``_dense``, ``_ffn``, ``_lm_logits``, ``_sample``) over a gathered page
view, and the exact -1e30 masking makes greedy tokens equal to
single-sequence ``generate()`` under staggered arrivals, eviction and
cancellation churn.

Reliability (serving/reliability.py): per-request deadlines and work
budgets enforced at step boundaries, an SLO-aware predicted-TTFT
admission gate with lowest-priority-first load shedding, graceful
``drain()`` (SIGTERM via ``install_preemption_handler``), a per-step
request journal driving ``recover()`` (bit-identical greedy
continuations after a host crash), and per-request poison quarantine —
non-finite logits abort only the offending lane, detected on the same
batched fetch as the sampled tokens.

The single-pool feature set (ROADMAP A10b):

- ``prefix_cache=True``: the pool's radix tree (kv_cache.py) is consulted
  at admission; cached prompt blocks are mapped read-only into the new
  request's page table, the first divergent block COW-split, and the
  covered prefill chunks never dispatched. Finished prefills publish
  their prompt blocks.
- ``speculative=k`` (greedy only): ONE fixed-shape draft-verify dispatch
  scores each lane's current token plus k host-drafted tokens; the host
  accepts the longest draft prefix equal to the dispatch's own argmax
  continuation plus one bonus token, which equals step-by-step greedy by
  construction.
- ``sparse_context={...}`` (sparse_context.py): decode and prefill gather
  K active pages per lane instead of all W, and pages that fall below
  every remaining query's window return to the allocator early.

Telemetry (``telemetry=``: a ``Telemetry`` or a dict of its keyword
arguments; the JAX engine's ``_arm_telemetry``): host-time spans and
instants on lane ``serve`` (``serving_step``, ``deadline_sweep``,
``prefill_tick``, ``decode_step``, ``admit``, ``drain_requested``,
``journal_commit``, ``abort_<reason>``, ``recover``), one JSONL record
per step (host values only: no fetch of its own), the decode MFU from the
dispatched programs' FLOPs (counted on meta tensors at report time), and
the memory report (the pool priced byte for byte, each dispatch a window
over the CUDA allocator's peak). Warmup traffic emits spans but no step
record.

The program registry (``program_registry``; telemetry/programs.py):
every decode, prefill, verify and sparse program registers at its first
dispatch through ``_dispatch``, with the JAX engine's pool contract (no
host read, no collective, the pool tensors updated in place), and the
prefix cache's COW copy as ``cow_copy``; the lint
(telemetry/program_lint.py) observes one dispatch of each. The one host
fetch after a dispatch lies outside its program, as the JAX engine's
``device_get`` lies outside its jit.

Each option that cannot arm warns DISARMED naming its blocker and serves
without it. Not ported yet, raising NotImplementedError naming its
ROADMAP item: pools split into shards and the fleet's request hand-off
(A10c).
"""
import itertools
import time

import numpy as np
import torch

from deepspeed_tpu_torch.models.generation import (_attn_core, _dense,
                                                   _ffn, _lm_logits, _ln,
                                                   _sample, _split_heads,
                                                   decode_params)
from deepspeed_tpu_torch.runtime.quantization import (dequantize_rows,
                                                      quantize_rows)
from deepspeed_tpu_torch.runtime.resilience import chaos
from deepspeed_tpu_torch.serving.kv_cache import TRASH_BLOCK, PagedKVPool
from deepspeed_tpu_torch.serving.metrics import (DispatchShapes,
                                                 ServingMetrics)
from deepspeed_tpu_torch.serving.reliability import (ABORT_BUDGET,
                                                     ABORT_EXPIRED,
                                                     ABORT_POISONED,
                                                     ABORT_SHED,
                                                     Reliability,
                                                     ReliabilityConfig,
                                                     RequestJournal)
from deepspeed_tpu_torch.serving.scheduler import (Request, RequestState,
                                                   Scheduler)
from deepspeed_tpu_torch.serving.sparse_context import (SparseContext,
                                                        _policy_layout)
from deepspeed_tpu_torch.telemetry.programs import ProgramRegistry
from deepspeed_tpu_torch.utils.logging import logger

_MIN_BUCKET = 4
_M32 = 0xFFFFFFFF


def _not_ported(what, item):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP {item})")


def _tree_numel(tree) -> int:
    if isinstance(tree, torch.Tensor):
        return tree.numel()
    if isinstance(tree, dict):
        return sum(_tree_numel(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_tree_numel(v) for v in tree)
    return 0


def _pool_write(pool, scales, l, blk, off, rows, quantized):
    """Scatter one K or V row per (lane, head) into the block pool, in
    place. rows: (N, H, D); blk/off: (N,) block id / in-block offset.
    Masked lanes arrive with blk == TRASH_BLOCK and land in the trash
    block — the scatter itself is always dense."""
    N, H, D = rows.shape
    if quantized:
        q, s = quantize_rows(rows.reshape(N * H, D), block_size=D)
        pool[l, blk, :, off, :] = q.reshape(N, H, D)
        scales[l, blk, :, off] = s.reshape(N, H)
    else:
        pool[l, blk, :, off, :] = rows.to(pool.dtype)


def _pool_view(pool, scales, l, tables, quantized, out_dtype):
    """Gather per-sequence page views back to contiguous position order:
    (B, W) tables over (L, NB, H, bs, D) pool -> (B, H, W*bs, D). View
    position j IS absolute sequence position j, so the attention mask of
    the contiguous cache applies unchanged."""
    B, W = tables.shape
    _, _, H, bs, D = pool.shape
    flat = tables.reshape(-1)
    g = pool[l].index_select(0, flat)
    g = g.reshape(B, W, H, bs, D).permute(0, 2, 1, 3, 4) \
        .reshape(B, H, W * bs, D)
    if not quantized:
        return g
    s = scales[l].index_select(0, flat).reshape(B, W, H, bs) \
        .permute(0, 2, 1, 3).reshape(B * H * W * bs, 1)
    return dequantize_rows(g.reshape(B * H * W * bs, D), s, D,
                           out_dtype).reshape(B, H, W * bs, D)


def _paged_forward(params, cfg, pools, tables, pos, maxpos, blk, off, x,
                   quantized, sparse=None, allowed=None):
    """Shared transformer pass of decode and chunked prefill: per layer,
    write this step's K/V rows into the pool, gather the page view, and
    run the SAME attention core the contiguous cache uses. x: (B, T, E)
    with T query tokens per lane; pos: the (B*T,) absolute positions of
    the query tokens, flattened to match blk/off.

    ``maxpos``: (B,) last VALID absolute position per lane. View
    positions beyond it have their keys and VALUES zeroed before the
    attention products: their softmax weight is already exactly 0 (the
    -1e30 score mask), but ``0 * NaN = NaN`` — without the value mask,
    stale non-finite garbage in a reused/trash block (a quarantined
    request's poisoned writes) would leak into every lane that merely
    gathers the block at a masked position. For finite garbage the
    zeroing is bit-neutral.

    ``sparse`` (serving/sparse_context.py): ``(stables, sbase)``, a (B, K)
    physical-page gather table and the absolute view position of each
    page's first token. The GATHER then reads only K active pages per
    lane while WRITES keep addressing the full page table through
    ``blk``/``off``; padded and window-expired entries carry the
    sentinel position (beyond every valid pos and maxpos), so both masks
    reject them like dense trash padding. The masks are built from the
    TRUE view positions, so the view's order does not matter.
    ``allowed`` (B, T, K*bs) further restricts each query to its OWN
    policy blocks (a prefill chunk gathers the union of its queries'
    sets)."""
    pk, pv, ksc, vsc = pools
    B, T, _ = x.shape
    H, D = cfg.n_head, cfg.head_dim
    bs = pk.shape[3]
    if sparse is None:
        gtables = tables
        view = torch.arange(tables.shape[1] * bs, device=x.device)[None]
    else:
        gtables, sbase = sparse
        view = (sbase[:, :, None] + torch.arange(bs, device=x.device)) \
            .reshape(B, -1)                                 # (B, K*bs)
    validj = view[:, None, :] <= pos.reshape(B, T)[:, :, None]
    if allowed is not None:
        validj = validj & allowed
    validj = validj[:, None]                                # (B, 1, T, V)
    validk = (view <= maxpos[:, None])[:, None, :, None]    # (B, 1, V, 1)
    eps = cfg.layer_norm_epsilon
    for l, bp in enumerate(params["blocks"]):
        h = _ln(x, bp["ln_1"], eps)
        q, k, v = _dense(h, bp["attn"]["c_attn"]).split(cfg.n_embd, dim=-1)
        q = _split_heads(q, B, T, H, D)                     # (B, H, T, D)
        _pool_write(pk, ksc, l, blk, off, k.reshape(B * T, H, D), quantized)
        _pool_write(pv, vsc, l, blk, off, v.reshape(B * T, H, D), quantized)
        kview = _pool_view(pk, ksc, l, gtables, quantized, x.dtype)
        vview = _pool_view(pv, vsc, l, gtables, quantized, x.dtype)
        kview = torch.where(validk, kview, 0)
        vview = torch.where(validk, vview, 0)
        x = x + _attn_core(q, kview, vview, validj, bp["attn"], x.dtype)
        x = x + _ffn(_ln(x, bp["ln_2"], eps), bp)
    return _ln(x, params["ln_f"], eps)


def _pick_next(logits, seeds, pos, sampling):
    """Greedy argmax (the bit-parity path) or per-lane sampled token."""
    temperature, top_k, top_p = sampling
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    return _sample(logits, seeds, pos, temperature, top_k, top_p)


def _decode_step(params, cfg, pools, buf, S, W, quantized, sampling, K=0):
    """ONE fixed-shape decode step over every slot lane. ``buf`` packs
    the (S, W) page tables, then positions, tokens, active mask and
    sampling seeds (S each), then the per-lane poison stream as fp32
    bits (0.0 in production, bit-neutral on the embedding sum; chaos
    writes NaN into one lane to model a numeric blow-up). Returns (2, S):
    the next tokens and the per-lane finiteness flags, fetched together.

    ``K`` > 0 is the sparse decode step (dispatched as
    ``sparse_decode_step``): the (S, K) active-page table and its (S, K)
    view bases follow the page tables in ``buf``, and the gather reads
    those K pages per lane instead of all W. The single query needs no
    per-query mask: its active row IS its policy set."""
    bs = pools[0].shape[3]
    ints = buf[:-S].long()
    tables = ints[:S * W].reshape(S, W)
    o = S * W
    sparse = None
    if K:
        sparse = ints[o:o + 2 * S * K].reshape(2, S, K).unbind(0)
        o += 2 * S * K
    pos, tok, active, seeds = ints[o:].reshape(4, S)
    poison = buf[-S:].view(torch.float32)
    active = active.bool()
    x = params["wte"][tok][:, None, :] + params["wpe"][pos][:, None, :]
    x = x + poison.to(x.dtype)[:, None, None]
    lanes = torch.arange(S, device=buf.device)
    blk = torch.where(active, tables[lanes, pos // bs], TRASH_BLOCK)
    off = pos % bs
    x = _paged_forward(params, cfg, pools, tables, pos, pos, blk, off, x,
                       quantized, sparse=sparse)
    logits = _lm_logits(params, cfg, x[:, 0])
    finite = torch.isfinite(logits).all(dim=-1)
    nxt = _pick_next(logits, seeds, pos, sampling)
    nxt = torch.where(active, nxt, 0)
    return torch.stack([nxt, finite.long()])


def _prefill_chunk(params, cfg, pools, buf, C, W, quantized, final,
                   sampling, layout=None):
    """One prefill chunk of (padded) length C for ONE sequence. ``buf``
    packs its (W,) page-table row, the C tokens, then start, n_valid and
    the sampling seed. Positions past n_valid are padding: their writes
    land in the trash block and nothing attends them. The final chunk
    returns (2, 1): the first token and its finiteness flag.

    ``layout`` (the sparse policy's (W, W) bool block layout, on the
    device) makes it the sparse prefill chunk (dispatched as
    ``sparse_prefill_chunk<C>``): the chunk's K-page gather row and its
    view bases follow the page-table row in ``buf``, K = (len(buf) - W -
    C - 3) / 2. The row is the UNION of the chunk queries' active sets,
    so each (query, key block) pair is masked by the layout."""
    bs = pools[0].shape[3]
    ints = buf.long()
    row = ints[:W]
    o = W
    sparse = None
    if layout is not None:
        K = (buf.numel() - W - C - 3) // 2
        sparse = ints[o:o + 2 * K].reshape(2, 1, K).unbind(0)
        o += 2 * K
    tokens = ints[o:o + C]
    start, n_valid, seed = ints[o + C:o + C + 3]
    ar = torch.arange(C, device=buf.device)
    posns = start + ar                                  # (C,)
    x = params["wte"][tokens][None] \
        + params["wpe"][posns.clamp(max=cfg.n_positions - 1)][None]
    valid_i = ar < n_valid
    blk = torch.where(valid_i, row[(posns // bs).clamp(max=W - 1)],
                      TRASH_BLOCK)
    off = posns % bs
    last = (start + n_valid - 1).reshape(1)
    allowed = None
    if sparse is not None:
        qb = (posns // bs).clamp(max=W - 1)                 # (C,)
        sblk = (sparse[1][0] // bs).clamp(max=W - 1)        # (K,)
        allowed = layout[qb[:, None], sblk[None, :]] \
            .repeat_interleave(bs, dim=1)[None]             # (1, C, K*bs)
    x = _paged_forward(params, cfg, pools, row[None], posns, last, blk, off,
                       x, quantized, sparse=sparse, allowed=allowed)
    if not final:
        return None
    xe = x[0].index_select(0, (n_valid - 1).reshape(1))    # (1, E)
    logits = _lm_logits(params, cfg, xe)
    finite = torch.isfinite(logits).all(dim=-1)
    nxt = _pick_next(logits, seed.reshape(1), last, sampling)
    return torch.stack([nxt, finite.long()])


def _spec_verify(params, cfg, pools, buf, S, T, W, quantized):
    """Self-speculative draft-verify: T = k+1 query tokens per lane (the
    current token plus k drafted) scored in ONE fixed-shape step.
    ``buf`` packs the (S, W) page tables, the positions (S), the (S, T)
    tokens, then ``nvalid``, active (S each) and the poison stream as
    fp32 bits. Greedy only (the arming gate enforces temperature 0), so
    no seeds enter.

    ``nvalid`` bounds the query positions that may write and that feed
    the finiteness detector: a lane within k tokens of its budget sends
    its surplus positions to the trash block, so it neither writes past
    its page table nor trips a false quarantine on clamped-gather
    garbage. Rejected positions are overwritten by the next dispatch
    before any query can attend them unmasked. Returns (S, T+1): the T
    argmax tokens and the lane's finiteness flag, fetched together."""
    bs = pools[0].shape[3]
    ints = buf[:-S].long()
    tables = ints[:S * W].reshape(S, W)
    o = S * W
    pos = ints[o:o + S]
    toks = ints[o + S:o + S + S * T].reshape(S, T)
    nvalid, active = ints[o + S + S * T:].reshape(2, S)
    poison = buf[-S:].view(torch.float32)
    active = active.bool()
    ar = torch.arange(T, device=buf.device)
    posns = pos[:, None] + ar[None, :]                      # (S, T)
    x = params["wte"][toks] \
        + params["wpe"][posns.clamp(max=cfg.n_positions - 1)]
    x = x + poison.to(x.dtype)[:, None, None]
    valid_q = ar[None, :] < nvalid[:, None]                 # (S, T)
    writable = active[:, None] & valid_q & (posns < W * bs)
    lanes = torch.arange(S, device=buf.device)[:, None]
    blk = torch.where(writable,
                      tables[lanes, (posns // bs).clamp(max=W - 1)],
                      TRASH_BLOCK)
    off = posns % bs
    maxpos = pos + nvalid - 1
    x = _paged_forward(params, cfg, pools, tables, posns, maxpos,
                       blk.reshape(-1), off.reshape(-1), x, quantized)
    logits = _lm_logits(params, cfg, x.reshape(S * T, -1)).reshape(S, T, -1)
    finite = torch.where(valid_q, torch.isfinite(logits).all(dim=-1),
                         True).all(dim=1)                   # (S,)
    nxt = torch.where(active[:, None], torch.argmax(logits, dim=-1), 0)
    return torch.cat([nxt, finite.long()[:, None]], dim=1)


def _accepted(drafts, row, nvalid):
    """Tokens one verify delivers to a lane: the longest prefix of
    ``drafts`` equal to the dispatch's own argmax continuation ``row``,
    plus the bonus token, at most ``nvalid``."""
    m = 1
    while m <= len(drafts) and drafts[m - 1] == row[m - 1]:
        m += 1
    return min(m, int(nvalid))


class InferenceEngine:
    """Continuous-batching serving engine (see module docstring).

    ``model`` is a ``GPT2Model``; ``params`` its weights as
    ``generation.decode_params`` reads them (None: the model's own).
    ``temperature``/``top_k``/``top_p`` are ENGINE-static; per-request
    randomness comes from each request's ``seed``. temperature=0 (greedy)
    is the bit-parity configuration. Runs on ``device`` (``cuda`` by
    default; ``"cpu"`` on request).
    """

    def __init__(self, model, params=None, *, max_slots=4, kv_block_size=16,
                 kv_blocks=None, max_blocks_per_seq=None, prefill_chunk=16,
                 quantize_kv=False, temperature=0.0, top_k=0, top_p=0.0,
                 policy="continuous", shards=1, mesh=None,
                 watchdog=None, clock=time.monotonic,
                 reliability=None, telemetry=None, prefix_cache=False,
                 speculative=None, sparse_context=None,
                 prefill_fairness=0, device=None):
        cfg = model.config
        assert not getattr(cfg, "moe_num_experts", 0), \
            "InferenceEngine serves dense blocks only: chunked prefill " \
            "changes MoE capacity-gating semantics (generation._moe_ffn " \
            "gates whole prompts); use models.generation.generate for MoE"
        if shards != 1 or mesh is not None:
            raise _not_ported("serving over pools split into shards "
                              "(shards > 1, mesh)", "A10c")
        if getattr(model, "tp_group", None) is not None:
            raise _not_ported("serving a tensor-parallel model (mesh model "
                              "> 1)", "A7c")
        assert prefill_chunk >= _MIN_BUCKET \
            and (prefill_chunk & (prefill_chunk - 1)) == 0, \
            f"prefill_chunk must be a power of two >= {_MIN_BUCKET}"
        from deepspeed_tpu_torch.runtime.engine import resolve_device

        self.device = resolve_device(device)
        self.model, self.cfg = model, cfg
        self.params = decode_params(model, params, self.device)
        self.max_slots = int(max_slots)
        self.shards = 1
        self.bs = int(kv_block_size)
        self.W = int(max_blocks_per_seq
                     or -(-int(cfg.n_positions) // self.bs))
        if kv_blocks is None:
            kv_blocks = 1 + max_slots * self.W     # never evicts
        self.pool = PagedKVPool(cfg, num_blocks=kv_blocks,
                                block_size=self.bs, quantize_kv=quantize_kv,
                                device=self.device)
        self.prefill_chunk = int(prefill_chunk)
        self.temperature = float(temperature)
        self.top_k = int(top_k or 0)
        self.top_p = float(top_p or 0.0)
        self._sampling = (self.temperature, self.top_k, self.top_p)
        self.scheduler = Scheduler(max_slots, policy=policy)
        self.scheduler.prefix_probe = self._prefix_probe
        self.clock = clock
        self.metrics = ServingMetrics(clock)
        self.dispatch_shapes = DispatchShapes()
        self.pool.dispatch_shapes = self.dispatch_shapes
        # the dispatched-program registry, always on (one dict insert per
        # program at its first dispatch)
        self._programs = ProgramRegistry("serving")
        self.pool.programs = self._programs
        self.results = {}
        self._watchdog = watchdog
        self._last_metrics = {}
        self._step_idx = 0
        self._rids = itertools.count()
        self._warming = False
        self._drain_requested = False
        self._arm_telemetry(telemetry)
        rel_cfg = reliability if isinstance(reliability, ReliabilityConfig) \
            else ReliabilityConfig(**(reliability or {}))
        self.reliability = Reliability(self, rel_cfg)
        S = self.max_slots
        self._tables = np.full((S, self.W), TRASH_BLOCK, np.int32)
        self._pos = np.zeros(S, np.int32)
        self._tok = np.zeros(S, np.int32)
        self._active = np.zeros(S, bool)
        self._seeds = np.zeros(S, np.uint32)
        self._poison = np.zeros(S, np.float32)
        self.prefix_cache = self._arm_prefix_cache(prefix_cache,
                                                   quantize_kv)
        self._readmit_rids = set()
        self.spec_k = self._arm_speculative(speculative)
        self._drafts = np.zeros((S, max(1, self.spec_k)), np.int32)
        # sparse page attention arms AFTER speculation (draft-k is one of
        # its DISARMED blockers) and picks the decode dispatch
        self.sparse = self._arm_sparse_context(sparse_context)
        self.prefill_fairness = int(prefill_fairness or 0)
        if self.prefill_fairness and policy != "continuous":
            logger.warning(
                "prefill fairness: DISARMED — the static batch gate "
                "already runs each batch to completion; the pause "
                "quantum only applies to continuous batching.")
            self.prefill_fairness = 0
        self._stables = self._sbase = self._layout = None
        self._decode_name = "decode_step"
        if self.sparse is not None:
            sp = self.sparse
            self._stables = np.full((S, sp.K), TRASH_BLOCK, np.int32)
            self._sbase = np.full((S, sp.K), int(sp.sentinel), np.int32)
            self._layout = torch.as_tensor(
                _policy_layout(sp.win, sp.g, self.W) > 0, device=self.device)
            self._decode_name = "sparse_decode_step"

    # -- arming ---------------------------------------------------------
    def _arm_prefix_cache(self, requested, quantize_kv_requested):
        """COW shared-prefix caching arms only where its bookkeeping is
        honest; every blocked request warns naming the blocker (the
        armed-or-warns DISARMED discipline). The cache itself is
        sampling-safe (cached KV rows are a pure function of the token
        prefix), so unlike speculation it does not require greedy."""
        if not requested:
            return False
        if quantize_kv_requested and not self.pool.quantized:
            logger.warning(
                "prefix cache: DISARMED — int8 KV was requested but the "
                "pool disarmed it (off-profitability: scale overhead >= "
                "byte savings at this head_dim/dtype); refusing to stack "
                "block sharing on a pool whose storage already silently "
                "differs from the asked-for config.  Serving without "
                "prefix caching.")
            return False
        if self.scheduler.draining:
            logger.warning(
                "prefix cache: DISARMED — the engine is draining: "
                "admission is closed, so no request could ever consult "
                "the tree; arming now would only pin blocks a successor "
                "cannot inherit.")
            return False
        return True

    def _arm_speculative(self, spec):
        """Self-speculative decoding (``speculative=k`` or ``{"draft_len":
        k}``) arms only in the greedy configuration: acceptance compares
        ARGMAX continuations token for token, so with sampling the
        accepted prefix would not equal the sampled stream. Blocked
        requests warn DISARMED naming the blocker and serve the plain
        decode step. Returns the armed draft length (0 = disarmed)."""
        if not spec:
            return 0
        k = int(spec.get("draft_len", 4)) if isinstance(spec, dict) \
            else int(spec)
        if k < 1:
            logger.warning(
                "speculative decoding: DISARMED — draft_len=%d < 1 "
                "drafts nothing; serving the plain decode step.", k)
            return 0
        if self.temperature != 0.0:
            logger.warning(
                "speculative decoding: DISARMED — sampling != greedy: "
                "temperature=%g, but the acceptance rule (accepted "
                "prefix == step-by-step greedy argmax) is only defined "
                "at temperature=0; a sampled stream would diverge from "
                "the verified continuations.  Serving the plain decode "
                "step.", self.temperature)
            return 0
        return k

    def _arm_sparse_context(self, spec):
        """Sparse page attention (``sparse_context=`` as a policy dict, an
        ``ops/sparse_attention`` SparsityConfig-style object, or a
        prebuilt :class:`SparseContext`) arms only where the policy maps
        soundly onto the paged pool; every blocked request warns DISARMED
        naming the blocker and the engine serves dense attention.
        Blockers: a token window that is not a multiple of the pool block
        size, beam search (active-page lists are single-hypothesis),
        draft-k speculation (the verify gathers the full table), and
        non-prefix global anchors. Returns the SparseContext or None."""
        if not spec:
            return None
        if self.spec_k:
            logger.warning(
                "sparse context: DISARMED — draft-k speculative decoding "
                "is armed (draft_len=%d): the verify step scores K+1 "
                "query tokens against the FULL page table and its "
                "acceptance rule assumes dense attention; composing the "
                "two gather policies is not supported yet.  Serving "
                "dense attention.", self.spec_k)
            return None
        if isinstance(spec, SparseContext):
            if spec.bs != self.bs or spec.W != self.W:
                logger.warning(
                    "sparse context: DISARMED — the supplied "
                    "SparseContext was compiled for block_size=%d/"
                    "table_width=%d but this engine runs %d/%d; its LUT "
                    "would address the wrong pages.  Serving dense "
                    "attention.", spec.bs, spec.W, self.bs, self.W)
                return None
            return spec
        if isinstance(spec, dict):
            d = dict(spec)
            beam = int(d.pop("beam_width", 1) or 1)
            if beam > 1:
                logger.warning(
                    "sparse context: DISARMED — beam_width=%d > 1: beam "
                    "lanes share pages under different hypotheses and "
                    "the per-lane active-page lists are single-"
                    "hypothesis.  Serving dense attention.", beam)
                return None
            wt = d.pop("window_tokens", None)
            if wt is not None:
                if int(wt) % self.bs != 0:
                    logger.warning(
                        "sparse context: DISARMED — window_tokens=%d is "
                        "not a multiple of the KV block size %d: the "
                        "policy's block granularity must BE the pool's "
                        "block size or the window edge lands mid-page.  "
                        "Round the window to a block multiple (e.g. %d "
                        "or %d).  Serving dense attention.",
                        int(wt), self.bs,
                        (int(wt) // self.bs) * self.bs,
                        (int(wt) // self.bs + 1) * self.bs)
                    return None
                d.setdefault("num_sliding_window_blocks",
                             int(wt) // self.bs)
            win = int(d.get("num_sliding_window_blocks", 0))
            if win < 1:
                logger.warning(
                    "sparse context: DISARMED — num_sliding_window_"
                    "blocks=%d < 1 cannot cover the query's own block.  "
                    "Serving dense attention.", win)
                return None
            return SparseContext(block_size=self.bs, table_width=self.W,
                                 **d)
        try:
            return SparseContext.from_sparsity_config(
                spec, block_size=self.bs, table_width=self.W)
        except ValueError as e:
            logger.warning(
                "sparse context: DISARMED — %s.  Serving dense "
                "attention.", e)
            return None

    def _arm_telemetry(self, spec):
        """Arm the serving telemetry session from the ``telemetry=``
        kwarg: ``None`` (off), a ``Telemetry`` instance, or a dict of
        Telemetry kwargs (plus ``"enabled"``). Disarmed serving holds
        ``self._tracer = None``: one attribute check per step. A config
        handed in with ``enabled=false`` or with every channel off would
        observe nothing, so it warns DISARMED instead of silently dropping
        the ask."""
        self.telemetry = None
        self._tracer = None
        self._owns_telemetry = False
        self._lane_serve = 0
        self._memacct = None
        if spec is None:
            return
        from deepspeed_tpu_torch.runtime.memory_accounting import \
            MemoryAccounting
        from deepspeed_tpu_torch.telemetry import Telemetry

        if isinstance(spec, Telemetry):
            tel = spec
        else:
            self._owns_telemetry = True
            cfg = dict(spec)
            if not cfg.pop("enabled", True):
                logger.warning(
                    "serving telemetry: DISARMED — a telemetry config was "
                    "passed with enabled=false; no trace, step stream or "
                    "MFU accounting will be produced")
                return
            tel = Telemetry(**cfg)
        if tel.tracer is None and tel.stream is None and tel.mfu is None:
            logger.warning(
                "serving telemetry: every channel is off (trace=false, "
                "metrics_jsonl unset, mfu=false) — effectively DISARMED")
        self.telemetry = tel
        self._tracer = tel.tracer
        if self._tracer is not None:
            self._lane_serve = self._tracer.lane("serve")
            self._tracer.intern("serving_step", args=("step",))
            self._tracer.intern("decode_step", args=("lanes",))
            self._tracer.intern("admit", args=("rid",))
        # the measured side: each dispatch a window over the allocator
        self._memacct = MemoryAccounting(self.device)

    def export_trace(self, path, complete_events=True):
        """Chrome-trace JSON of the retained events (None when tracing
        is disarmed); spans are host time."""
        tr = self._tracer
        if tr is None:
            return None
        return tr.export_chrome_trace(path, complete_events=complete_events)

    def close_telemetry(self):
        """Close the metrics-stream file handle of a telemetry session
        THIS engine created from a dict spec (a caller-provided
        ``Telemetry`` instance is the caller's to close). Idempotent;
        also runs at GC."""
        if getattr(self, "_owns_telemetry", False) \
                and self.telemetry is not None:
            self.telemetry.close()

    def __del__(self):
        try:
            self.close_telemetry()
        except Exception:  # interpreter teardown can fail imports mid-GC;
            # never raise from __del__
            pass

    @property
    def program_registry(self):
        """The engine's dispatched-program registry (always armed): every
        serving program dispatched so far, with its declarative contract.
        Read by ``python -m deepspeed_tpu_torch.telemetry.program_lint``."""
        return self._programs

    def _pool_contract(self, **extra):
        """The contract every pool-threading program shares (JAX
        ``_pool_contract``): pure device work, no collective, and the
        paged KV pool (argument 1) updated in place."""
        contract = {"host_transfer_free": True, "collective_free": True,
                    "donates_argnums": (1,)}
        contract.update(extra)
        return contract

    # -- not ported yet -------------------------------------------------
    def export_request(self, rid):
        raise _not_ported("request hand-off between replicas "
                          "(export_request)", "A10c")

    def import_request(self, entry):
        raise _not_ported("request hand-off between replicas "
                          "(import_request)", "A10c")

    # -- public API -----------------------------------------------------
    @property
    def capacity_per_seq(self) -> int:
        """Longest admissible prompt+max_new: the position budget
        (n_positions), the page-table width, AND the usable block pool
        all bound it."""
        return min(int(self.cfg.n_positions), self.W * self.bs,
                   (self.pool.blocks_per_shard - 1) * self.bs)

    def submit(self, prompt, max_new_tokens, *, priority=0,
               eos_token_id=None, seed=0, deadline_s=None,
               work_budget=None, _generated=None, _rid=None,
               _work_done=0, _readmit=False) -> int:
        """Submit one request. ``deadline_s``/``work_budget`` (engine
        defaults from the ReliabilityConfig) bound its wall-clock life
        and total scheduled token-writes; under predicted SLO overload
        the admission gate may shed lower-priority queued work or turn
        this request away (``results[rid]["status"] == "shed"``).
        ``_generated``/``_rid``/``_work_done`` are the :meth:`recover`
        re-submission hooks (journal replay through the eviction
        re-prefill path); ``_readmit=True`` marks a recovery
        re-submission: the request was ADMITTED once already, so the SLO
        admission gate must not shed it again — it is journaled
        directly."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        assert prompt.size >= 1 and max_new_tokens >= 1
        total = prompt.size + int(max_new_tokens)
        assert total <= self.capacity_per_seq, \
            f"prompt+max_new={total} exceeds per-sequence capacity " \
            f"{self.capacity_per_seq} (W={self.W} blocks x {self.bs}, " \
            f"{self.pool.blocks_per_shard - 1} usable blocks)"
        rel_cfg = self.reliability.config
        if self._warming:
            deadline_s = work_budget = None   # synthetic warmup traffic
        else:
            if deadline_s is None:
                deadline_s = rel_cfg.default_deadline_s
            if work_budget is None:
                work_budget = rel_cfg.default_work_budget
        if deadline_s is not None and float(deadline_s) <= 0:
            raise ValueError(
                f"deadline_s={deadline_s} is not a positive budget: the "
                f"request would expire before its first step ever runs. "
                f"Submit with deadline_s=None (no deadline) or a positive "
                f"number of seconds.")
        rid = next(self._rids) if _rid is None else int(_rid)
        if deadline_s is not None and not self._warming and not _readmit:
            # deadline-impossible max_new: even PERFECT service — an
            # empty queue, every step at the measured EMA — cannot fit
            # the minimum step count inside the budget.  Reject at
            # admission instead of burning prefill work that is
            # guaranteed to expire mid-flight.
            ema = self.metrics.step_time()
            min_steps = -(-int(prompt.size) // self.prefill_chunk) \
                + int(max_new_tokens)
            if ema is not None and min_steps * ema > float(deadline_s):
                logger.warning(
                    "submit(rid=%d): deadline-impossible — prompt=%d "
                    "tokens + max_new=%d needs >= %d engine steps; at "
                    "the measured %.4fs/step that is a %.3fs zero-queue "
                    "lower bound, over deadline_s=%.3f.  Rejected at "
                    "admission (no prefill work wasted).  Raise "
                    "deadline_s or shrink max_new_tokens.",
                    rid, prompt.size, int(max_new_tokens), min_steps,
                    ema, min_steps * ema, float(deadline_s))
                self.results[rid] = {
                    "tokens": prompt.copy(), "status": ABORT_EXPIRED,
                    "evictions": 0,
                }
                self.metrics.record_finish(rid, ABORT_EXPIRED)
                if self._tracer is not None:
                    self._tracer.instant(f"abort_{ABORT_EXPIRED}",
                                         self._lane_serve, a0=rid)
                return rid
        req = Request(rid=rid, prompt=prompt,
                      max_new_tokens=int(max_new_tokens),
                      priority=int(priority), eos_token_id=eos_token_id,
                      seed=int(seed), deadline_s=deadline_s,
                      work_budget=work_budget)
        if deadline_s is not None:
            req.deadline = self.clock() + float(deadline_s)
        if _generated:
            req.generated = [int(t) for t in _generated]
        if _work_done:
            req.work_done = int(_work_done)
        # TTFT class: "long" prompts (several prefill chunks) vs chatty
        # "short" ones
        self.metrics.record_submit(
            rid, klass="long" if prompt.size >= 4 * self.prefill_chunk
            else "short")
        if not self._warming:
            if _readmit:
                # already-admitted work (recovery): bypass the shedding
                # gate, but journal it here so THIS engine's crash covers
                # it too; tagged so the prefix probe can attribute cache
                # savings to the recovery path
                self._readmit_rids.add(rid)
                if self.reliability.journal is not None:
                    self.reliability.journal.record_submit(req)
            elif self.reliability.on_submit(req) == "reject":
                self.results[rid] = {
                    "tokens": np.asarray(req.full_tokens, np.int32),
                    "status": ABORT_SHED, "evictions": 0,
                }
                self.metrics.record_finish(rid, ABORT_SHED)
                return rid
        self.scheduler.submit(req)
        return rid

    def cancel(self, rid) -> bool:
        req = self.scheduler.cancel(rid)
        if req is None:
            return False
        self._cleanup(req, "cancelled")
        return True

    def step(self) -> dict:
        """One serving tick: chaos hooks, deadline/budget enforcement,
        at most one prefill chunk, one batched decode dispatch, then
        host-side bookkeeping on a SINGLE batched token+finiteness
        fetch, and the journal's step-boundary commit."""
        self._step_idx += 1
        tr = self._tracer
        _t0 = tr.begin() if tr is not None else 0.0
        slow = chaos.serving_slow_step_s(self._step_idx)
        if slow:
            time.sleep(slow)
        if self._watchdog is not None:
            self._watchdog.observe_serving_step(self._step_idx)
        if self._drain_requested:
            if tr is not None and not self.scheduler.draining:
                tr.instant("drain_requested", self._lane_serve,
                           a0=self._step_idx)
            self.scheduler.draining = True
        events = {"admitted": [], "finished": [], "evicted": [],
                  "cancelled": [], "expired": [], "budget": [],
                  "poisoned": []}
        rid = self.scheduler.chaos_cancel()
        if rid is not None and self.cancel(rid):
            events["cancelled"].append(rid)
        if tr is None:
            self._enforce_deadlines(events)
            self._prefill_tick(events)
            decoded = self._decode_tick(events)
        else:
            _t = tr.begin()
            self._enforce_deadlines(events)
            tr.complete("deadline_sweep", self._lane_serve, _t)
            _t = tr.begin()
            self._prefill_tick(events)
            tr.complete("prefill_tick", self._lane_serve, _t)
            _t = tr.begin()
            decoded = self._decode_tick(events)
            tr.complete("decode_step", self._lane_serve, _t, a0=decoded)
            for rid_ in events["admitted"]:
                tr.instant("admit", self._lane_serve, a0=rid_)
        self.scheduler.on_drained()
        self.reliability.on_step_end()
        if tr is not None and self.reliability.journal is not None:
            tr.instant("journal_commit", self._lane_serve,
                       a0=self.reliability.journal_depth())
        occ = self.pool.occupancy()
        frag = self.pool.fragmentation()
        qd = self.scheduler.queue_depth()
        self.metrics.record_step(
            queue_depth=qd, running=decoded, slots=self.max_slots,
            occupancy=occ, fragmentation=frag, decoded=decoded > 0)
        rel = self.reliability
        self._last_metrics = {
            "step": self._step_idx, "queue_depth": qd,
            "running": len(self.scheduler.running),
            "kv_occupancy": occ, "kv_fragmentation": frag,
            "decoded_lanes": decoded,
            "events": {k: len(v) for k, v in events.items()},
            "shed": rel.aborts[ABORT_SHED],
            "expired": rel.aborts[ABORT_EXPIRED],
            "poisoned": rel.aborts[ABORT_POISONED],
            "journal_depth": rel.journal_depth(),
            "draining": self.scheduler.draining,
            "prefix_hit_rate": self.metrics.prefix_hit_rate(),
            "prefix_avoided_tokens": self.metrics.prefix_avoided_tokens,
            "prefill_tokens_computed":
                self.metrics.prefill_computed_tokens,
            "tokens_per_verify": self.metrics.tokens_per_verify(),
            "spec_accept_hist": dict(self.metrics.spec_accept_hist),
            "active_page_fraction": self.metrics.active_page_fraction(),
            "window_expired_frees": self.metrics.window_expired_frees,
            "short_ttft_p95": self.metrics.class_ttft_p95("short"),
        }
        if tr is not None:
            tr.complete("serving_step", self._lane_serve, _t0,
                        a0=self._step_idx)
        if self.telemetry is not None and not self._warming:
            self.telemetry.on_step(self._step_idx, self._last_metrics)
        return events

    def serve(self, *, max_steps=100000) -> dict:
        steps = 0
        while self.scheduler.has_work():
            if self._drain_requested and not self.scheduler.in_flight():
                break    # drained: waiting work stays journaled
            if steps >= max_steps:
                raise RuntimeError(
                    f"serve() exceeded max_steps={max_steps} with "
                    f"{self.scheduler.queue_depth()} queued")
            self.step()
            steps += 1
        return self.results

    # -- reliability lifecycle (drain / recover) ------------------------
    def request_drain(self) -> None:
        """Ask for a graceful drain: admission stops at the next step
        boundary, in-flight requests run to completion, queued requests
        stay journaled for a successor's :meth:`recover`.  Signal-
        handler safe: only sets a flag."""
        self._drain_requested = True

    def install_preemption_handler(self, signals=None) -> None:
        """Route SIGTERM (a preemption notice) into :meth:`request_drain`.
        Any previously installed Python-level handler is CHAINED, not
        replaced, so a process hosting both a training engine and a
        serving engine preempts the trainer AND drains the server on one
        SIGTERM. Main thread only (a Python signal-handler constraint)."""
        import signal as signal_mod

        from deepspeed_tpu_torch.runtime.resilience.watchdog import \
            chain_signal_handlers

        sigs = chain_signal_handlers(self.request_drain, signals)
        logger.info("serving preemption handler installed for %s",
                    [signal_mod.Signals(s).name for s in sigs])

    def drain(self, *, max_steps=100000) -> dict:
        """Graceful shutdown: stop admission, finish every in-flight
        request (deadlines still enforced), commit the journal, and
        return the results so far.  Queued requests stay live in the
        journal; a replacement engine picks them up via :meth:`recover`."""
        self.request_drain()
        self.scheduler.draining = True
        steps = 0
        while self.scheduler.in_flight():
            if steps >= max_steps:
                raise RuntimeError(
                    f"drain() exceeded max_steps={max_steps} with "
                    f"{len(self.scheduler.running)} still running")
            self.step()
            steps += 1
        self.reliability.on_step_end()
        left = self.scheduler.queue_depth()
        if left and self.reliability.journal is None:
            logger.warning(
                "drain: %d queued requests have NO journal armed "
                "(ReliabilityConfig.journal_path unset) — they are lost "
                "on exit instead of recoverable.", left)
        return self.results

    def recover(self, journal_path) -> list:
        """Crash recovery: replay a (dead predecessor's) request journal
        and re-submit every live request — with its journaled generated
        tokens — through the SAME re-prefill path eviction uses, so
        greedy continuations are bit-identical to the uninterrupted
        run.  Original rids and FCFS order are preserved; deadlines
        restart (the journal stores the relative budget).  Returns the
        recovered rids."""
        assert not self.scheduler.has_work(), "recover() on a busy engine"
        entries = RequestJournal.replay(journal_path)
        rids = []
        max_rid = -1
        for e in entries:
            rid = self.submit(
                np.asarray(e["prompt"], np.int32),
                e["max_new"], priority=e["priority"],
                eos_token_id=e["eos"], seed=e["seed"],
                deadline_s=e["deadline_s"], work_budget=e["work_budget"],
                _generated=e["generated"], _rid=e["rid"],
                _work_done=e.get("work_done", 0), _readmit=True)
            rids.append(rid)
            max_rid = max(max_rid, rid)
        self._rids = itertools.count(max_rid + 1)
        if self._tracer is not None:
            self._tracer.instant("recover", self._lane_serve, a0=len(rids))
        logger.info("recover: re-submitted %d journaled requests from %s",
                    len(rids), journal_path)
        return rids

    def warmup(self) -> None:
        """Dispatch every program the steady state can need — the decode
        step (or the draft-verify, or the sparse decode step) plus each
        (bucket, final/non-final) prefill variant (sparse ones under a
        sparse policy) that an ADMISSIBLE request can reach, and the
        prefix cache's COW copy — by serving throwaway requests, then
        reset results/metrics.  After warmup, request churn adds NO new
        dispatch signature.

        Coverage argument: a final chunk of residue r takes the same
        shapes as any residue in its power-of-two bucket, and every
        reachable bucket admits a single-chunk prompt of length r
        (multi-chunk prompts only shrink the admissible residue), so one
        short prompt per bucket plus ONE prompt longer than
        prefill_chunk (iff any admissible prompt is) covers everything."""
        assert not self.scheduler.has_work(), "warmup on a busy engine"
        # warmup traffic is synthetic: bypass the admission gate and the
        # journal (a recovery replay must never see throwaway requests)
        self._warming = True
        cap = self.capacity_per_seq
        lens = set()
        for b in self._buckets():
            n = b if b == _MIN_BUCKET else b // 2 + 1
            if n + 1 <= cap:
                lens.add(n)               # single-chunk final, bucket b
        if cap - 1 > self.prefill_chunk:
            # some admissible prompt spans chunks: dispatch the non-final
            # (always full-chunk) variant too
            lens.add(min(2 * self.prefill_chunk, cap - 1))
        for ln in sorted(lens):
            self.submit(np.zeros(ln, np.int32),
                        max_new_tokens=min(2, cap - ln))
        if cap >= 3:
            # the first token comes from the prefill-final chunk; the
            # decode step only runs on a SECOND token — guarantee one
            # even when every bucket prompt above could only afford
            # max_new=1
            self.submit(np.zeros(1, np.int32), max_new_tokens=2)
        self.serve()
        if self.prefix_cache:
            # the COW copy is the one device write outside the dispatch
            # functions that the cache can reach: record it here
            self.pool.warm_cow()
        self._warming = False
        self.results.clear()
        self.metrics.reset()
        self._last_metrics = {}
        self._step_idx = 0

    def result(self, rid) -> np.ndarray:
        """prompt + generated tokens of a finished/cancelled request."""
        return self.results[rid]["tokens"]

    def serving_report(self) -> dict:
        """TTFT / TPOT / throughput / queue-depth / KV-pool occupancy of
        the run so far: pure host accounting, no device sync."""
        rep = self.metrics.report()
        rep["config"] = {
            "max_slots": self.max_slots, "shards": self.shards,
            "kv_block_size": self.bs, "kv_blocks": self.pool.num_blocks,
            "max_blocks_per_seq": self.W,
            "prefill_chunk": self.prefill_chunk,
            "quantized_kv": self.pool.quantized,
            "policy": self.scheduler.policy,
            "temperature": self.temperature, "top_k": self.top_k,
            "top_p": self.top_p,
            "prefix_cache": self.prefix_cache,
            "speculative_draft_len": self.spec_k,
            "sparse_context": self.sparse.describe()
            if self.sparse is not None else None,
            "prefill_fairness": self.prefill_fairness,
            "device": str(self.device),
        }
        rep["kv_pool"]["now"] = self.pool.stats()
        rep["reliability"] = self.reliability.report()
        rep["dispatch"] = {"signatures": len(self.dispatch_shapes),
                           "dispatches": self.dispatch_shapes.dispatches,
                           "programs": self.dispatch_shapes.names()}
        return rep

    def telemetry_report(self) -> dict:
        """Unified observability report (the serving face of the training
        engine's ``telemetry_report()``): the full ``serving_report()`` plus
        the telemetry sections — metrics registry snapshot, trace summary,
        the memory report and the decode MFU/HFU ledger (``mfu``; its first
        call counts the dispatched programs' FLOPs on meta tensors)."""
        rep = self.serving_report()
        tel = self.telemetry
        # the training engine's top-level schema, mirrored under
        # "telemetry" as the JAX engine does
        rep["telemetry_armed"] = tel is not None
        rep["telemetry"] = {"armed": tel is not None}
        rep["memory"] = self.memory_report()
        if tel is None:
            return rep
        rep["metrics"] = rep["telemetry"]["metrics"] = \
            tel.registry.snapshot()
        if tel.tracer is not None:
            rep["trace"] = rep["telemetry"]["trace"] = tel.tracer.summary()
        if tel.mfu is not None:
            from deepspeed_tpu_torch.telemetry import mfu

            n_params = _tree_numel(self.params)
            # decode model FLOPs: 2ND forward-only over every dispatched
            # lane (idle lanes still compute)
            rep["mfu"] = tel.mfu.report(
                step_time_s=self.metrics.step_time() or tel.step_time_s(),
                n_devices=max(1, self.shards),
                model_flops=mfu.model_flops_per_step(
                    n_params, self.max_slots, fwd_only=True),
                device_kind=mfu.device_kind(self.device))
            rep["mfu"]["n_params"] = n_params
            rep["mfu"]["tokens_per_step"] = self.max_slots
        return rep

    def memory_report(self) -> dict:
        """The serving face of the memory accounting: analytic device
        bytes — the decode weights plus the paged KV block pool, priced
        through ``memory_accounting.kv_pool_bytes`` (the pool's own
        ``device_bytes()``, byte-exact against its tensors) — beside the
        measured windows of each dispatched program and the allocator's
        in-use/peak bytes (None on the CPU). Cold report builder."""
        from deepspeed_tpu_torch.runtime import memory_accounting as mem_acc

        pool_bytes = self.pool.device_bytes()
        params_bytes = mem_acc.tree_device_bytes(self.params)
        analytic = {
            "components": {"params_bytes": params_bytes,
                           "kv_pool_bytes": pool_bytes},
            "persistent_bytes": params_bytes + pool_bytes,
            "transient_bytes": 0,
            "peak_bytes": params_bytes + pool_bytes,
        }
        return mem_acc.memory_report(
            analytic=analytic, accounting=self._memacct, devices=self.device,
            extra={"engine": type(self).__name__})

    def n_pool_tensors(self) -> int:
        return len(self.pool.tensors.arrays)

    # -- dispatch -------------------------------------------------------
    def _upload(self, buf):
        """One host-to-device transfer of a packed int32 buffer: through
        pinned memory and without a host sync on the card (the caching
        host allocator keeps the pinned block until the copy is done)."""
        t = torch.from_numpy(buf)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def _dispatch(self, name, fn, buf, *args, group=None):
        """Run one decode/prefill program over the pool, recording its
        signature and registering it (``group``: its uniform_group)."""
        pools = self.pool.tensors
        self.dispatch_shapes.record(name, pools.arrays + (buf,))
        extra = {} if group is None else {"uniform_group": group}
        obs = self._programs.dispatch(
            name, (self.params, lambda: self.pool.tensors, buf),
            self._pool_contract(**extra))
        acct = self._memacct
        if self.telemetry is not None:
            # capture by shape: the FLOPs are counted at report time
            from deepspeed_tpu_torch.telemetry import mfu

            mfu.register_fn(self.telemetry.mfu, name, fn,
                            (self.params, self.cfg, tuple(pools), buf)
                            + args)
            acct.register(name)
            acct.begin(name)
        with torch.no_grad(), obs:
            out = fn(self.params, self.cfg, tuple(pools), buf, *args)
            obs.outputs(out)
        if acct is not None:
            acct.end(name)
        return out

    @staticmethod
    def _fetch(out):
        """THE host fetch of a dispatch: tokens and finiteness flags in one
        device-to-host copy."""
        host = out.cpu().numpy()
        return host[0], host[1].astype(bool)

    # -- internals ------------------------------------------------------
    def _buckets(self):
        b, out = _MIN_BUCKET, []
        while b <= self.prefill_chunk:
            out.append(b)
            b *= 2
        return out

    def _bucket(self, n):
        for b in self._buckets():
            if n <= b:
                return b
        raise AssertionError(f"chunk {n} > prefill_chunk")

    def _prefix_probe(self, req):
        """Admission-time prefix consult (the scheduler's
        ``prefix_probe``): map cached prompt blocks read-only into the new
        request's page table and advance ``prefill_done`` past them, so
        the covered chunks are never dispatched. Journal-replayed
        requests take the same path: their re-prefill shares the prompt
        blocks."""
        if not self.prefix_cache or self._warming:
            return 0
        hit = self.pool.prefix_attach(req.rid, req.shard, req.full_tokens)
        if hit:
            req.prefill_done = hit
        self.metrics.record_prefix_lookup(
            hit, readmit=req.rid in self._readmit_rids)
        return hit

    def _ensure_blocks(self, req, n_positions, *, admission, events):
        """Grow ``req``'s page table to cover ``n_positions``, preempting
        victims from the scheduler's policy until the pool has room.
        False = req itself was deferred/evicted (caller must not use
        it this step)."""
        while not self.pool.alloc(req.rid, req.shard, n_positions):
            victim = self.scheduler.victim(for_req=req,
                                           admission=admission,
                                           shard=req.shard)
            if victim is None:
                if admission:
                    self.scheduler.drop_prefill(req, requeue=True)
                    self.pool.free(req.rid)
                else:
                    self._evict(req, events)
                return False
            self._evict(victim, events)
        return True

    def _evict(self, req, events):
        slot = req.slot
        self.scheduler.preempt(req)
        self.pool.free(req.rid)
        self._clear_slot(slot)
        self.metrics.record_eviction(req.rid)
        events["evicted"].append(req.rid)

    def _clear_slot(self, slot):
        if slot is None:
            return
        self._active[slot] = False
        self._tables[slot] = TRASH_BLOCK
        self._pos[slot] = 0
        self._tok[slot] = 0
        if self.sparse is not None:
            self._stables[slot] = TRASH_BLOCK
            self._sbase[slot] = int(self.sparse.sentinel)

    def _cleanup(self, req, reason):
        self.pool.free(req.rid)
        self._clear_slot(req.slot)
        self.results[req.rid] = {
            "tokens": np.concatenate(
                [req.prompt, np.asarray(req.generated, np.int32)]),
            "status": reason, "evictions": req.evictions,
        }
        self.metrics.record_finish(req.rid, reason)
        if not self._warming:
            self.reliability.on_finish(req, reason)

    def _abort(self, req, reason, events=None):
        """Terminal non-completion in ANY live state (waiting, prefill,
        running): scheduler bookkeeping, KV blocks freed, slot scrubbed,
        result recorded with the explicit reason."""
        self.scheduler.finish(req, reason)
        self._cleanup(req, reason)
        if self._tracer is not None:
            self._tracer.instant(f"abort_{reason}", self._lane_serve,
                                 a0=req.rid)
        if events is not None and reason in events:
            events[reason].append(req.rid)

    def _enforce_deadlines(self, events):
        """Step-boundary deadline + work-budget enforcement over every
        live request: pure host accounting, no device syncs."""
        now = self.clock()
        for req in list(self.scheduler.requests.values()):
            if req.state in (RequestState.FINISHED,
                             RequestState.CANCELLED):
                continue
            if req.deadline is not None and now > req.deadline:
                self._abort(req, ABORT_EXPIRED, events)
            elif req.work_budget is not None \
                    and req.work_done >= req.work_budget:
                self._abort(req, ABORT_BUDGET, events)

    def _finish(self, req, reason, events):
        self.scheduler.finish(req, reason)
        self._cleanup(req, reason)
        events["finished"].append(req.rid)

    def _on_new_token(self, req, token, events, *, promote):
        req.generated.append(int(token))
        self.metrics.record_token(req.rid)
        if not self._warming:
            self.reliability.on_token(req, int(token))
        if req.done:
            self._finish(req, "finished", events)
            return
        if promote:
            self.scheduler.promote(req)
            slot = req.slot
            self._tables[slot] = self.pool.table_row(req.rid, self.W)
            self._pos[slot] = len(req.full_tokens) - 1
            self._tok[slot] = req.generated[-1]
            self._seeds[slot] = req.seed & _M32
            self._active[slot] = True

    def _prefill_tick(self, events):
        sch = self.scheduler
        req = sch.prefilling
        if req is None:
            req = sch.start_admission()
            if req is not None:
                events["admitted"].append(req.rid)
            else:
                # no fresh admission (empty queue or no free slot): give
                # the lane back to the oldest fairness-paused prefill
                req = sch.resume_prefill()
            if req is None:
                return
        toks = req.full_tokens
        total = len(toks)
        start = req.prefill_done
        n = min(self.prefill_chunk, total - start)
        final = start + n == total
        # the final chunk also reserves the first decode write position
        if not self._ensure_blocks(req, start + n + (1 if final else 0),
                                   admission=True, events=events):
            return
        sp = self.sparse
        if sp is not None:
            # blocks below the chunk's FIRST query window (keeping the
            # global anchors) are already unreachable: free them before
            # building the table row, as the decode tick does
            freed = self.pool.window_expired_free(
                req.rid, sp.first_active_block(start), keep_blocks=sp.g)
            if freed:
                self.metrics.record_window_expired(freed)
        bucket = self._bucket(n)
        row = self.pool.table_row(req.rid, self.W)
        parts = [row]
        if sp is not None:
            parts += list(sp.prefill_active_row(row, start, n, bucket))
        tok_pad = np.zeros(bucket, np.int32)
        tok_pad[:n] = toks[start:start + n]
        seed = np.uint32(req.seed & _M32).view(np.int32)
        buf = np.concatenate(parts + [tok_pad,
                                      np.asarray([start, n, seed],
                                                 np.int32)])
        prefix = "sparse_" if sp is not None else ""
        name = f"{prefix}prefill_chunk{bucket}" + ("_final" if final else "")
        # bucketed prefills at one schedule slot must post identical
        # collective sequences (JAX engine.py:1650-1661)
        group = f"serving:{prefix}prefill" + ("_final" if final else "")
        out = self._dispatch(name, _prefill_chunk, self._upload(buf), bucket,
                             self.W, self.pool.quantized, final,
                             self._sampling, self._layout, group=group)
        req.work_done += n
        self.metrics.record_prefill(n)
        if final:
            toks_out, fins = self._fetch(out)
            req.prefill_done = total
            if not fins[0]:
                self._abort(req, ABORT_POISONED, events)
                return
            if self.prefix_cache and not self._warming:
                # publish the (finite-checked) prompt blocks: the next
                # request sharing this prefix skips their chunks
                self.pool.prefix_insert(req.rid, req.shard, req.prompt)
            self._on_new_token(req, int(toks_out[0]), events, promote=True)
        else:
            req.prefill_done = start + n
            if self.prefill_fairness:
                # chunked-prefill fairness: after a quantum of chunks a
                # huge prompt yields the lane IF anyone is waiting for it
                req.fair_chunks += 1
                if req.fair_chunks >= self.prefill_fairness and \
                        (sch.peek_waiting() is not None or sch.paused):
                    sch.pause_prefill(req)

    def _pack_decode(self):
        """The decode step's packed input (see ``_decode_step``)."""
        sparse = [] if self.sparse is None \
            else [self._stables.reshape(-1), self._sbase.reshape(-1)]
        return np.concatenate([self._tables.reshape(-1)] + sparse + [
            self._pos, self._tok,
            self._active.astype(np.int32), self._seeds.view(np.int32),
            self._poison.view(np.int32)])

    def _draft_tokens(self, req, k):
        """Host-side n-gram drafter: propose the continuation that
        followed the most recent earlier occurrence of the current last
        token (repeating the last token when history has none).
        Deterministic and correctness-free: the verify accepts only the
        exact greedy prefix, so a bad draft costs speed, never parity."""
        toks = req.full_tokens
        last = int(toks[-1])
        out = None
        for i in range(len(toks) - 2, -1, -1):
            if int(toks[i]) == last:
                cont = [int(t) for t in toks[i + 1:i + 1 + k]]
                if cont:
                    out = cont
                break
        if out is None:
            out = [last]
        while len(out) < k:
            out.append(out[-1])
        return out[:k]

    def _spec_decode_tick(self, events):
        """Speculative variant of the decode tick: ONE fixed-shape
        draft-verify dispatch scores the current token plus K drafts per
        lane; the host accepts the longest draft prefix matching the
        dispatch's own argmax stream (plus the bonus token). Same single
        fetch, poison quarantine and fixed shapes as the plain tick."""
        sch = self.scheduler
        if not sch.running:
            return 0
        K, S = self.spec_k, self.max_slots
        # growth: each lane writes up to min(K+1, remaining) positions
        # this step; cover them, preempting if the pool is full
        for slot in sorted(sch.running):
            req = sch.running.get(slot)
            if req is None:
                continue
            n = min(K + 1, req.max_new_tokens - len(req.generated))
            self._ensure_blocks(req, int(self._pos[slot]) + n,
                                admission=False, events=events)
        running = dict(sch.running)
        if not running:
            return 0
        if chaos.serving_poison_step(self._step_idx):
            victim = max(running.values(), key=lambda r: r.submit_seq)
            self._poison[victim.slot] = np.nan
            chaos.record_serving_poison(victim.rid)
        nvalid = np.zeros(S, np.int32)
        toks_in = np.zeros((S, K + 1), np.int32)
        for slot, req in running.items():
            self._tables[slot] = self.pool.table_row(req.rid, self.W)
            n = min(K + 1, req.max_new_tokens - len(req.generated))
            nvalid[slot] = n
            toks_in[slot, 0] = self._tok[slot]
            drafts = self._draft_tokens(req, K)
            toks_in[slot, 1:] = drafts
            self._drafts[slot] = drafts
            req.work_done += n
        lanes = len(running)
        self.metrics.record_gather(
            lanes, lanes * self.W, lanes * self.W,
            sum(self.pool.blocks_of(r.rid) for r in running.values()))
        buf = np.concatenate([
            self._tables.reshape(-1), self._pos, toks_in.reshape(-1), nvalid,
            self._active.astype(np.int32), self._poison.view(np.int32)])
        out = self._dispatch("spec_verify", _spec_verify, self._upload(buf),
                             S, K + 1, self.W, self.pool.quantized)
        self._poison[:] = 0.0
        chaos.serving_kill_step(self._step_idx)
        # ONE fetch: K+1 argmax tokens per lane and the finiteness flags
        host = out.cpu().numpy()
        outs, fins = host[:, :-1], host[:, -1].astype(bool)
        for slot, req in running.items():
            if not fins[slot]:
                self._abort(req, ABORT_POISONED, events)
                continue
            row = outs[slot]
            m = _accepted(self._drafts[slot], row, nvalid[slot])
            consumed = 0
            for i in range(m):
                consumed += 1
                self._on_new_token(req, int(row[i]), events,
                                   promote=False)
                if req.done:
                    break
            self.metrics.record_verify(consumed)
            if sch.running.get(slot) is req:
                self._pos[slot] += consumed
                self._tok[slot] = int(row[consumed - 1])
        return lanes

    def _decode_tick(self, events):
        if self.spec_k:
            return self._spec_decode_tick(events)
        sch = self.scheduler
        if not sch.running:
            return 0
        # growth: each lane writes position pos this step — make sure its
        # page table covers it, preempting if the pool is full
        for slot in sorted(sch.running):
            req = sch.running.get(slot)
            if req is None:
                continue
            self._ensure_blocks(req, int(self._pos[slot]) + 1,
                                admission=False, events=events)
        running = dict(sch.running)
        if not running:
            return 0
        # chaos poison: NaN into the youngest DISPATCHED lane's embedding
        # (chosen after the growth loop so an evicted lane is never the
        # victim) — its logits go non-finite and must be quarantined
        if chaos.serving_poison_step(self._step_idx):
            victim = max(running.values(), key=lambda r: r.submit_seq)
            self._poison[victim.slot] = np.nan
            chaos.record_serving_poison(victim.rid)
        sp = self.sparse
        for slot, req in running.items():
            if sp is not None:
                # pages below every remaining query's window (keeping the
                # global anchors) can never be gathered again: return
                # them before refreshing the row, so this step's row
                # already shows the holes
                freed = self.pool.window_expired_free(
                    req.rid, sp.first_active_block(int(self._pos[slot])),
                    keep_blocks=sp.g)
                if freed:
                    self.metrics.record_window_expired(freed)
            self._tables[slot] = self.pool.table_row(req.rid, self.W)
            if sp is not None:
                self._stables[slot], self._sbase[slot] = sp.active_row(
                    self._tables[slot], int(self._pos[slot]))
            req.work_done += 1
        lanes = len(running)
        if sp is not None:
            nonpad = int(sum((self._sbase[slot] != int(sp.sentinel)).sum()
                             for slot in running))
            self.metrics.record_gather(lanes, lanes * sp.K, lanes * self.W,
                                       nonpad)
        else:
            self.metrics.record_gather(
                lanes, lanes * self.W, lanes * self.W,
                sum(self.pool.blocks_of(r.rid) for r in running.values()))
        out = self._dispatch(self._decode_name, _decode_step,
                             self._upload(self._pack_decode()),
                             self.max_slots, self.W, self.pool.quantized,
                             self._sampling, sp.K if sp is not None else 0)
        self._poison[:] = 0.0
        # kill-mid-decode chaos: the dispatch happened, NO host
        # bookkeeping has — the journal holds the last committed step
        chaos.serving_kill_step(self._step_idx)
        toks, fins = self._fetch(out)
        for slot, req in running.items():
            if not fins[slot]:
                # per-request fault isolation: quarantine THIS request;
                # its blocks are freed and the value mask keeps any NaN
                # it wrote from ever reaching another lane's products
                self._abort(req, ABORT_POISONED, events)
                continue
            self._pos[slot] += 1
            self._tok[slot] = int(toks[slot])
            self._on_new_token(req, int(toks[slot]), events,
                               promote=False)
        return len(running)

