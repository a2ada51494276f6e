"""Mixture-of-Experts with expert parallelism.

Port of deepspeed_tpu/moe/sharded_moe.py:

- **Gating** (GShard top-2 / Switch top-1, ``top_k_gating``): dense one-hot
  dispatch and combine tensors built from cumulative-sum slot positions,
  no scatter and no data-dependent shapes, so a step makes no host sync.
- **Experts** (``StackedExperts``): the E expert FFNs as stacked ``(E,
  ...)`` parameters, one batched product per projection.
- **Expert parallelism**: the JAX layer shards the stacks over the
  ``data`` mesh axis and lets GSPMD insert the token exchange. Here each
  process of a data-parallel group of ``dp`` ranks holds E/dp experts
  (``expert_parallel``), and the dispatched tokens cross the group in one
  all-to-all each way (``parallel.mesh.expert_exchange``). The load-balance
  statistics are means over the global batch, as in the JAX program: each
  rank's means are averaged over the group before their product. With
  one rank every expert is local and nothing is exchanged.
- **Static capacity**: ``capacity = ceil(k * tokens * capacity_factor /
  E)`` per token group (a batch row); overflow tokens are dropped (their
  combine weight is zero) and ride the residual connection.

The layer returns ``(out, aux)``: ``aux`` is the load-balance loss (and
the router z-loss) already scaled by its coefficients, an output of the
call rather than module state, so that a recomputed (checkpointed) call
neither counts it twice nor loses its gradient.
"""
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from deepspeed_tpu_torch.ops.transformer.functional import gelu
from deepspeed_tpu_torch.ops.transformer.transformer import _trunc_normal_
from deepspeed_tpu_torch.parallel.mesh import (DATA_AXIS, MODEL_AXIS,
                                               expert_exchange, global_mean)


def moe_capacity(tokens_per_group: int, num_experts: int, k: int,
                 capacity_factor: float, min_capacity: int = 4) -> int:
    """Static per-expert slot count for one token group."""
    cap = int(math.ceil(k * tokens_per_group * capacity_factor / num_experts))
    return max(min_capacity, min(cap, tokens_per_group * k))


def _one_hot(idx, n):
    """(..., n) fp32 one-hot of ``idx``; an index outside [0, n) gives a
    zero row (as jax.nn.one_hot; F.one_hot would raise, and checks the
    range with a host read)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


def _argmax(rem):
    """Each token's next choice: torch.argmax, like jnp.argmax, takes the
    first index of a tie. (A seam: a parity check pins one run's choices
    on another by replacing it.)"""
    return torch.argmax(rem, dim=-1)


def top_k_gating(logits, k: int = 2, capacity: Optional[int] = None,
                 capacity_factor: float = 1.25, min_capacity: int = 4,
                 normalize: bool = True, group=None):
    """Dense top-k gating.

    logits: (G, S, E) router scores (any float dtype; softmax runs fp32).
    ``group``: the expert-parallel ``DataParallelGroup`` whose ranks hold
    the other rows of the global batch (None: this call sees all of it);
    the per-expert means of the load-balance loss and the kept-token count
    are taken over the group.
    Returns (combine, dispatch, aux_loss, metrics):
      combine:  (G, S, E, C) fp32, the weight of token (g, s) in slot c of
                expert e
      dispatch: (G, S, E, C) bool, combine > 0
      aux_loss: scalar fp32 load-balance loss (1.0 when balanced)
      metrics:  dict of scalars (aux, dropped fraction, load entropy)
    """
    G, S, E = logits.shape
    if capacity is None:
        capacity = moe_capacity(S, E, k, capacity_factor, min_capacity)
    probs = torch.softmax(logits.float(), dim=-1)

    masks, gates = [], []
    rem = probs
    for _ in range(k):
        m = _one_hot(_argmax(rem), E)                   # (G, S, E)
        gates.append(torch.sum(rem * m, dim=-1))        # (G, S)
        masks.append(m)
        rem = rem * (1.0 - m)

    # slots an expert already handed out to higher-priority choices: the
    # 2nd-choice positions start after ALL 1st-choice assignments (GShard's
    # locations2 += sum(mask1))
    normalize = normalize and k > 1
    gate_sum = sum(gates)
    combine = torch.zeros(G, S, E, capacity, device=logits.device)
    offset = torch.zeros(G, 1, E, device=logits.device)
    kept_tokens = torch.zeros((), device=logits.device)
    for m, g in zip(masks, gates):
        # the running count over S, taken along the innermost dim (CUDA's
        # scan over an outer dim is several times slower; 0/1 counts are
        # exact in fp32 in any order)
        loc = torch.cumsum(m.transpose(1, 2), dim=-1).transpose(1, 2) \
            - m + offset                                # (G, S, E)
        pos = torch.sum(loc * m, dim=-1)                # (G, S) slot index
        chosen = torch.sum(m, dim=-1)                   # (G, S) 0/1
        keep = (pos < capacity).float() * chosen
        kept_tokens = kept_tokens + torch.sum(keep)
        gn = g / torch.clamp(gate_sum, min=1e-9) if normalize else g
        slot = _one_hot(pos.long(), capacity)           # (G, S, C)
        combine = combine + (gn * keep)[..., None, None] \
            * m[..., None] * slot[:, :, None, :]
        offset = offset + torch.sum(m, dim=1, keepdim=True)

    # load-balance loss on first-choice routing (Switch section 2.2): the
    # product of the per-expert token fraction and mean router probability,
    # each a mean over the global batch
    stats = torch.cat([torch.mean(probs, dim=(0, 1)),
                       torch.mean(masks[0], dim=(0, 1)),
                       kept_tokens.reshape(1)])
    if group is not None and group.size > 1:
        stats = global_mean(stats, group)
    mean_prob, frac_tokens, kept = stats[:E], stats[E:2 * E], stats[2 * E]
    aux_loss = E * torch.sum(mean_prob * frac_tokens)

    dispatch = combine > 0
    load = frac_tokens + 1e-9
    metrics = {
        "moe_aux_loss": aux_loss,
        "moe_dropped_frac": 1.0 - kept / float(G * S * k),
        "moe_load_entropy": -torch.sum(load * torch.log(load)),
    }
    return combine, dispatch, aux_loss, metrics


def _cast(t, dtype, ct):
    """``t`` rounded to ``dtype``, then in ``ct``: an operand cast to the
    layer's dtype enters a product in the dtype jnp's promotion gives it
    with the other operand's (``torch.promote_types``)."""
    return t.to(dtype).to(ct)


class StackedExperts(nn.Module):
    """E parallel FFN experts as stacked weights: ``w_in (E, M, F)``,
    ``b_in (E, F)``, ``w_out (E, F, M)``, ``b_out (E, M)``, fp32, one
    batched product per projection in the compute dtype, tanh GELU.
    Under expert parallelism the module holds this rank's E/dp experts.

    Input/output: (E, N, M)."""

    def __init__(self, num_experts: int, d_model: int, d_ff: int,
                 dtype=torch.bfloat16):
        super().__init__()
        E, M, Fd = num_experts, d_model, d_ff
        self.dtype = dtype
        self.w_in = nn.Parameter(torch.empty(E, M, Fd))
        self.b_in = nn.Parameter(torch.zeros(E, Fd))
        self.w_out = nn.Parameter(torch.empty(E, Fd, M))
        self.b_out = nn.Parameter(torch.zeros(E, M))

    def reset_with(self, generator):
        """Kernels N(0, 0.02), biases 0 (the JAX layer's initializers). The
        kernels are drawn on the parameters' own device, from a generator
        there seeded by one draw of ``generator`` (a CPU generator): the
        stacks hold most of an MoE model's parameters, and a host draw of
        gpt2-350m's 16-expert stacks takes seconds per layer. So a seed
        gives the same stacks on every device of one type, and other
        stacks on another."""
        seed = int(torch.randint(0, 2 ** 62, (), generator=generator))
        with torch.no_grad():
            gen = torch.Generator(device=self.w_in.device).manual_seed(seed)
            for w in (self.w_in, self.w_out):
                w.normal_(0.0, 0.02, generator=gen)
            self.b_in.zero_()
            self.b_out.zero_()

    def forward(self, x):
        ct = torch.promote_types(x.dtype, self.dtype)
        x = x.to(ct)
        h = torch.bmm(x, _cast(self.w_in, self.dtype, ct)) \
            + _cast(self.b_in, self.dtype, ct)[:, None, :]
        h = gelu(h, approximate=True)
        return torch.bmm(h, _cast(self.w_out, self.dtype, ct)) \
            + _cast(self.b_out, self.dtype, ct)[:, None, :]


class Router(nn.Linear):
    """The bias-free fp32 router: ``weight (E, M)`` (the JAX kernel's
    transpose), applied in fp32 whatever the dtype it is stored in (the
    engine's compute-dtype copy rounds it, as the JAX engine's does);
    lecun-normal like flax's Dense."""

    def __init__(self, d_model, num_experts):
        super().__init__(d_model, num_experts, bias=False)

    def reset_with(self, generator):
        _trunc_normal_(self.weight, math.sqrt(1.0 / self.in_features)
                       / 0.87962566103423978, generator)

    def forward(self, x):
        return F.linear(x.float(), self.weight.float())


class MoE(nn.Module):
    """Sparsely-gated MoE FFN block (a drop-in for a dense MLP).

    x: (B, S, M); each batch row is a routing group (static capacity per
    row). ``forward`` returns ``(out, aux)``: out (B, S, M), the caller
    adds the residual; aux the fp32 scalar ``aux_loss_coef * aux_loss``
    (plus ``router_z_loss_coef`` times the mean squared router
    logsumexp). ``generator`` draws the router jitter (train only).

    ``expert_group`` (set by ``expert_parallel``): the data-parallel group
    over which the experts are split; ``name`` labels the exchanges in
    its collective counter. ``generator`` (a CPU generator) initializes
    the parameters; without it they stay uninitialized for the caller's
    ``reset_with`` (a model initializes all its weights in one pass).
    """

    def __init__(self, d_model: int, num_experts: int, d_ff: int, k: int = 2,
                 capacity_factor: float = 1.25,
                 eval_capacity_factor: float = 0.0, min_capacity: int = 4,
                 aux_loss_coef: float = 0.01,
                 router_z_loss_coef: float = 0.0, router_jitter: float = 0.0,
                 dtype=torch.bfloat16, name: str = "moe",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_experts = num_experts
        self.d_ff = d_ff
        self.k = k
        self.capacity_factor = capacity_factor
        # 0 = same as capacity_factor; eval typically uses a larger factor
        self.eval_capacity_factor = eval_capacity_factor
        self.min_capacity = min_capacity
        self.aux_loss_coef = aux_loss_coef
        self.router_z_loss_coef = router_z_loss_coef
        self.router_jitter = router_jitter
        self.dtype = dtype
        self.name = name
        self.expert_group = None
        self.router = Router(d_model, num_experts)
        self.experts = StackedExperts(num_experts, d_model, d_ff, dtype)
        if generator is not None:
            self.reset_with(generator)

    def reset_with(self, generator):
        self.router.reset_with(generator)
        self.experts.reset_with(generator)

    def gate(self, x, train=True, generator=None):
        """The router logits (B, S, E) fp32 and ``top_k_gating``'s output
        for ``x``."""
        xr = x.float()
        if train and self.router_jitter > 0:
            j = self.router_jitter
            noise = torch.empty(xr.shape, device=xr.device)
            noise.uniform_(1.0 - j, 1.0 + j, generator=generator)
            xr = xr * noise
        logits = self.router(xr)
        cf = self.capacity_factor if train or not self.eval_capacity_factor \
            else self.eval_capacity_factor
        return (logits,) + top_k_gating(
            logits, k=self.k, capacity_factor=cf,
            min_capacity=self.min_capacity, group=self.expert_group)

    def forward(self, x, train=True, generator=None):
        B, S, M = x.shape
        logits, combine, dispatch, aux, _ = self.gate(x, train, generator)
        total_aux = self.aux_loss_coef * aux
        if self.router_z_loss_coef:
            z = torch.logsumexp(logits, dim=-1)
            zz = torch.mean(z * z)
            if self.expert_group is not None and self.expert_group.size > 1:
                zz = global_mean(zz.reshape(1), self.expert_group)[0]
            total_aux = total_aux + self.router_z_loss_coef * zz

        ct = torch.promote_types(x.dtype, self.dtype)
        d = torch.einsum("gsec,gsm->egcm", _cast(dispatch, self.dtype, ct),
                         x.to(ct))
        group = self.expert_group
        if group is not None and group.size > 1:
            # (E, B, C, M) -> this rank's experts over the global batch
            d = expert_exchange(d, group, f"{self.name}/dispatch", True)
        El, G, C = d.shape[:3]
        y = self.experts(d.reshape(El, G * C, M)).reshape(El, G, C, M)
        if group is not None and group.size > 1:
            y = expert_exchange(y, group, f"{self.name}/combine", False)
        out = torch.einsum("egcm,gsec->gsm", y,
                           _cast(combine, self.dtype, ct))
        return out, total_aux


def expert_parallel(module, group):
    """Split every ``MoE`` layer of ``module`` over ``group`` (a
    ``DataParallelGroup`` of dp ranks): rank r keeps experts [r*E/dp,
    (r+1)*E/dp) of each stack (the others' storage is freed) and routes
    its tokens over the group. The JAX engine refuses a stack whose E the
    data axis does not divide; so does this. Returns the names of the
    parameters now holding this rank's experts (dim 0 split)."""
    dp, rank = group.size, group.rank
    names = []
    for prefix, m in module.named_modules():
        if not isinstance(m, MoE):
            continue
        E = m.num_experts
        if E % dp:
            raise ValueError(
                f"{prefix}: {E} experts do not split over a data axis of "
                f"{dp} (the expert stacks shard their dimension 0 over "
                f"'data', which must divide it)")
        per = E // dp
        for pname, p in m.experts.named_parameters():
            p.data = p.data[rank * per:(rank + 1) * per].clone()
            names.append(f"{prefix}.experts.{pname}")
        m.expert_group = group
    return names


def moe_leaf_spec(joined: str):
    """Partition rule for MoE leaves (the JAX package's ``moe_leaf_spec``),
    as a tuple of mesh axis names per dim: expert stacks shard E over
    ``data`` (expert parallelism) and the FFN hidden dim over ``model``;
    the router is replicated. None for a leaf that is not the MoE's."""
    if "router" in joined:
        return ()
    if "experts" in joined:
        if "w_in" in joined:
            return (DATA_AXIS, None, MODEL_AXIS)
        if "w_out" in joined:
            return (DATA_AXIS, MODEL_AXIS, None)
        if "b_in" in joined:
            return (DATA_AXIS, MODEL_AXIS)
        if "b_out" in joined:
            return (DATA_AXIS, None)
        return (DATA_AXIS,)
    return None


def sum_moe_losses(losses) -> torch.Tensor:
    """The fp32 sum of the MoE layers' aux losses (an iterable of scalar
    tensors or a dict of them; None entries, dense blocks', skipped)."""
    if isinstance(losses, dict):
        losses = losses.values()
    total = None
    for aux in losses:
        if aux is None:
            continue
        aux = torch.sum(aux.float())
        total = aux if total is None else total + aux
    return torch.zeros(()) if total is None else total
