"""PipelineModule: a model expressed as a partitionable layer list.

Port of deepspeed_tpu/runtime/pipe/module.py (reference
deepspeed/runtime/pipe/module.py:23-575: LayerSpec lazy construction,
TiedLayerSpec shared weights, uniform / parameters / type:regex stage
partitioning, per-layer seeds, activation checkpointing every N layers).

The module is an ``nn.Module`` whose parameters are keyed per layer as the
JAX module's tree is: ``layer_00``, ``layer_01``, ... and a tied layer's
under ``tied_<key>`` (submodules of those names), so that checkpoints and the
converter (models/convert.py) line up leaf for leaf. It serves two
executors: the PipelineEngine, which copies each chunk's layers into a
chunk of its own (a tied layer is one parameter per chunk that uses it,
kept equal by the engine's tied-gradient reduction, as the JAX engine
keeps one per chunk), and user code through ``forward_full`` / ``loss``.

A layer module computes ``forward(x, train=False, generator=None)``; one
whose class sets ``has_aux = True`` returns ``(y, aux)``, its auxiliary
loss (MoE load balance) or None. A tied layer's ``forward_fn(module, x)``
replaces the forward of the layer it reuses (e.g. the LM head against the
embedding). A plain callable is a stateless layer. Dropout draws from a
generator that the executor makes for each layer (``layer_generator``), so
a chunk re-run in the backward redraws its forward's masks, and the masks
do not depend on how the layers are partitioned.
"""
import re

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from deepspeed_tpu_torch.runtime.utils import (partition_balanced,
                                               partition_uniform)
from deepspeed_tpu_torch.utils.logging import logger


class LayerSpec:
    """Lazily-built layer: stores the constructor and its arguments so that
    building waits until the module is made (reference module.py:23-68).
    ``forward_fn(module, x)``: an optional custom apply of the built
    module."""

    def __init__(self, typename, *module_args, forward_fn=None,
                 **module_kwargs):
        self.typename = typename
        self.module_args = module_args
        self.module_kwargs = module_kwargs
        self.forward_fn = forward_fn

    def build(self, log=False):
        if log:
            logger.info(f"building {repr(self)}")
        return self.typename(*self.module_args, **self.module_kwargs)

    def __repr__(self):
        name = getattr(self.typename, "__name__", str(self.typename))
        return f"LayerSpec({name})"


class TiedLayerSpec(LayerSpec):
    """Layer whose parameters are shared with every other spec carrying the
    same key: e.g. the embedding reused as the LM head (reference
    module.py:71-83)."""

    def __init__(self, key, typename, *module_args, forward_fn=None,
                 tied_weight_attr="embedding", **module_kwargs):
        super().__init__(typename, *module_args, forward_fn=forward_fn,
                         **module_kwargs)
        self.key = key
        self.tied_weight_attr = tied_weight_attr


class _Layer:
    """One entry of the layer list: its index, its parameters' key (None:
    stateless), its tie, and how it applies."""

    def __init__(self, index, param_key, type_name, forward_fn=None,
                 fn=None, has_aux=False):
        self.index = index
        self.param_key = param_key
        self.type_name = type_name
        self.forward_fn = forward_fn
        self.fn = fn                      # a stateless callable
        self.has_losses = has_aux
        self.tied_key = None
        self.is_tied_owner = False

    def apply(self, module, x, train, generator):
        """(y, aux) of this layer on ``x`` with ``module`` its parameters'
        holder (None for a stateless layer); aux None where it adds no
        loss."""
        if self.fn is not None:
            return self.fn(x), None
        if self.forward_fn is not None:
            return self.forward_fn(module, x), None
        out = module(x, train=train, generator=generator)
        if self.has_losses:
            return out
        return out, None


class PipelineModule(nn.Module):
    """Layer-list model, partitionable across pipeline stages.

    Args:
        layers: sequence of LayerSpec / TiedLayerSpec / nn.Modules /
            callables, applied in order.
        loss_fn: (final_output, batch) -> (scalar_loss, metrics dict).
        num_stages: pipeline depth (the engine sets its chunk count).
        partition_method: 'uniform' | 'parameters' | 'type:<regex>'
            (reference module.py:348-403).
        input_fn: batch -> first-stage input (default: batch['x']).
        activation_checkpoint_interval: recompute every N layers in the
            backward of the sequential path (reference module.py:292-346).
        seed_layers: initialize each layer from base_seed + its index,
            independent of the engine's seed (reference module.py:85).
    """

    def __init__(self, layers, loss_fn=None, num_stages=None, topology=None,
                 partition_method="parameters", input_fn=None,
                 activation_checkpoint_interval=0, seed_layers=False,
                 base_seed=1234):
        super().__init__()
        self.specs = list(layers)
        self.loss_fn = loss_fn
        self.num_stages = num_stages
        self.client_topology = topology
        self.partition_method = partition_method
        self.input_fn = input_fn or (lambda batch: batch["x"])
        self.activation_checkpoint_interval = activation_checkpoint_interval
        self.seed_layers = seed_layers
        self.base_seed = base_seed

        # {param key: module}; each is also a submodule named by its key, so
        # the parameter names are the JAX tree's (``layer_01.block...``)
        self.layer_modules = {}
        self._layers = []
        tied_owner = {}
        for i, spec in enumerate(self.specs):
            if isinstance(spec, TiedLayerSpec):
                key = f"tied_{spec.key}"
                if key not in self.layer_modules:
                    self._add_layer(key, spec.build())
                    tied_owner[key] = i
                obj = self.layer_modules[key]
                layer = _Layer(i, key, type(obj).__name__, spec.forward_fn,
                               has_aux=getattr(obj, "has_aux", False))
                layer.tied_key = spec.key
                layer.is_tied_owner = tied_owner[key] == i
            else:
                obj = spec.build() if isinstance(spec, LayerSpec) else spec
                forward_fn = spec.forward_fn \
                    if isinstance(spec, LayerSpec) else None
                if isinstance(obj, nn.Module) \
                        and any(True for _ in obj.parameters()):
                    key = f"layer_{i:02d}"
                    self._add_layer(key, obj)
                    layer = _Layer(i, key, type(obj).__name__, forward_fn,
                                   has_aux=getattr(obj, "has_aux", False))
                else:
                    layer = _Layer(i, None, type(obj).__name__, fn=obj)
            self._layers.append(layer)
        # per-layer parameter counts (a tied reuse counts 0, so the owner's
        # stage carries the weight)
        self._param_counts = [
            sum(p.numel() for p in self.layer_modules[l.param_key]
                .parameters())
            if l.param_key is not None and (l.tied_key is None
                                            or l.is_tied_owner) else 0
            for l in self._layers]
        self._parts = None

    def _add_layer(self, key, module):
        self.layer_modules[key] = module
        self.add_module(key, module)

    # ------------------------------------------------------------------
    # the engine's model contract
    # ------------------------------------------------------------------
    def init_weights(self, generator: torch.Generator):
        """Every layer's parameters, in layer order, from ``generator`` (or
        with ``seed_layers`` from its own base_seed + index): a layer
        module's ``init_weights(generator)`` where it has one, else its
        own construction-time values."""
        for layer in self._layers:
            if layer.param_key is None or (layer.tied_key is not None
                                           and not layer.is_tied_owner):
                continue
            mod = self.layer_modules[layer.param_key]
            if not hasattr(mod, "init_weights"):
                continue
            gen = torch.Generator().manual_seed(self.base_seed + layer.index) \
                if self.seed_layers else generator
            mod.init_weights(gen)

    @staticmethod
    def layer_generator(seed, device):
        """The dropout generator of one layer's call (the executor's
        ``seed`` folds the step, the micro-batch and the layer index), or
        None for seed None."""
        if seed is None or device.type == "meta":
            return None
        gen = torch.Generator(device=device)
        gen.manual_seed(seed % (2 ** 63))
        return gen

    def loss(self, batch, generator=None, train=True, seed=None):
        """(loss, metrics) of the sequential forward (reference
        module.loss): the layer-sown auxiliary losses join the training
        objective. ``seed`` seeds each layer's dropout as the pipeline
        engine does (``layer_seed``)."""
        assert self.loss_fn is not None, \
            "PipelineModule needs loss_fn to train"
        out, aux = self.forward_full(batch, train, seed=seed,
                                     return_aux=True)
        loss, metrics = self.loss_fn(out, batch)
        if train and aux is not None:
            loss = loss + aux
            metrics = dict(metrics, aux_loss=aux, loss=loss)
        return loss, metrics

    def forward(self, batch, train=False, seed=None):
        return self.forward_full(batch, train, seed=seed)

    def forward_full(self, batch, train=False, seed=None, return_aux=False,
                     modules=None):
        """Sequential (non-pipelined) forward through all layers, with
        activation checkpointing every N layers when configured."""
        x = self.input_fn(batch)
        interval = self.activation_checkpoint_interval
        if not (interval and train and torch.is_grad_enabled()):
            x, aux = self._apply_range(x, self._layers, train, seed, modules)
        else:
            aux = None
            for start in range(0, len(self._layers), interval):
                seg = self._layers[start:start + interval]

                def run(x, seg=seg):
                    y, a = self._apply_range(x, seg, train, seed, modules)
                    return y, (a if a is not None else
                               torch.zeros((), device=y.device))

                x, a = checkpoint(run, x, use_reentrant=False)
                if any(l.has_losses for l in seg):
                    aux = a if aux is None else aux + a
        return (x, aux) if return_aux else x

    @staticmethod
    def layer_seed(seed, index):
        """The dropout seed of layer ``index`` under the call's ``seed``."""
        return None if seed is None else seed * 1000003 + index

    def _apply_range(self, x, layers, train, seed, modules=None):
        """(y, aux) of ``layers`` applied in order to ``x``; ``modules``
        {param key: module} (a chunk's copies; default this module's)."""
        modules = self.layer_modules if modules is None else modules
        aux = None
        for layer in layers:
            mod = modules[layer.param_key] if layer.param_key is not None \
                else None
            gen = self.layer_generator(self.layer_seed(seed, layer.index),
                                       x.device) if train else None
            x, a = layer.apply(mod, x, train, gen)
            if a is not None:
                aux = a if aux is None else aux + a
        return x, aux

    def forward_stage(self, x, stage_id, train, seed=None, num_stages=None,
                      modules=None):
        """(y, aux) of stage (chunk) ``stage_id``'s layer range on ``x``:
        the PipelineEngine's hot path. aux is the chunk-local sum of the
        layers' auxiliary losses (None where there is none): it takes a
        direct gradient at this chunk, never through the activation's."""
        start, stop = self.stage_bounds(stage_id, num_stages)
        return self._apply_range(x, self._layers[start:stop], train, seed,
                                 modules)

    # ------------------------------------------------------------------
    # partitioning (reference module.py:348-403)
    # ------------------------------------------------------------------
    def stage_bounds(self, stage_id, num_stages=None):
        parts = self.partition_layers(num_stages)
        return parts[stage_id], parts[stage_id + 1]

    def partition_layers(self, num_stages=None):
        num_stages = num_stages or self.num_stages or 1
        if self._parts is not None and len(self._parts) == num_stages + 1:
            return self._parts
        n = len(self._layers)
        method = (self.partition_method or "uniform").lower()
        if method == "uniform":
            parts = partition_uniform(n, num_stages)
        elif method == "parameters":
            parts = partition_balanced(self._param_counts, num_stages)
        elif method.startswith("type:"):
            pattern = method.split(":", 1)[1]
            weights = [1 if re.search(pattern, l.type_name, re.IGNORECASE)
                       else 0 for l in self._layers]
            parts = partition_balanced(weights, num_stages)
        elif method == "profile":
            raise NotImplementedError(
                "profile partitioning is not implemented (parity: reference "
                "module.py:372 also raises)")
        else:
            raise KeyError(f"unknown partition method {self.partition_method}")
        self._parts = parts
        return parts

    def validate_chunking(self, stages, virtual_stages):
        """Blocker string (for the engine's DISARMED warning) if this layer
        list cannot be split into ``stages * virtual_stages`` interleaved
        chunks, else None: every chunk must be non-empty and the layer
        count must divide evenly."""
        chunks = stages * virtual_stages
        n = len(self._layers)
        if n % chunks != 0:
            return (f"layer count {n} is not divisible by pipe x "
                    f"virtual_stages = {stages} x {virtual_stages}")
        return None

    def has_tied_layers(self):
        """True when any layer shares parameters via TiedLayerSpec."""
        return any(l.tied_key is not None for l in self._layers)

    # ------------------------------------------------------------------
    # introspection used by the engine
    # ------------------------------------------------------------------
    @property
    def layers(self):
        return self._layers

    def stage_param_keys(self, stage_id, num_stages=None):
        """Parameter keys owned by a stage (chunk). Tied parameters belong
        to every chunk that uses them (the engine keeps them in sync)."""
        start, stop = self.stage_bounds(stage_id, num_stages)
        keys = []
        for layer in self._layers[start:stop]:
            if layer.param_key is not None and layer.param_key not in keys:
                keys.append(layer.param_key)
        return keys

    def tied_groups(self, num_stages=None):
        """{tie_key: sorted chunk ids using it} for ties that span chunks
        (reference module.py:420-474)."""
        num_stages = num_stages or self.num_stages or 1
        groups = {}
        for layer in self._layers:
            if layer.tied_key is None or layer.param_key is None:
                continue
            for s in range(num_stages):
                start, stop = self.stage_bounds(s, num_stages)
                if start <= layer.index < stop:
                    groups.setdefault(layer.tied_key, set()).add(s)
        return {k: sorted(v) for k, v in groups.items() if len(v) > 1}

    def layer_reference_tree(self, key, prefix):
        """The JAX tree of layer ``key``'s parameters: each leaf (the port's
        parameter name under ``prefix``, transposed). A layer module's own
        ``reference_tree(prefix)`` where it has one, else one leaf per
        parameter, keyed by its name's parts."""
        mod = self.layer_modules[key]
        if hasattr(mod, "reference_tree"):
            return mod.reference_tree(prefix)
        tree = {}
        for name, _ in mod.named_parameters():
            node = tree
            parts = name.split(".")
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = (prefix + name, False)
        return tree

    def reference_tree(self):
        """The JAX module's whole parameter tree over this module's names."""
        return {key: self.layer_reference_tree(key, f"{key}.")
                for key in self.layer_modules}

    def num_params(self):
        return sum(p.numel() for p in self.parameters())

    def mpu(self):
        return None
