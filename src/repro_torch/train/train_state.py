"""TrainState: parameters, AdamW state and step (port of
``repro.train.train_state``), its partition specs by the sharding rules
and the shardings that place it on a slice's mesh."""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.models import common
from repro_torch.models import sharding as shd
from repro_torch.models.registry import Model
from repro_torch.train import optimizer as opt


class TrainState(NamedTuple):
    params: Any
    opt_state: opt.AdamWState
    step: torch.Tensor


def init(model: Model, gen: torch.Generator,
         adamw: opt.AdamWConfig = opt.AdamWConfig(),
         device=None) -> TrainState:
    """Seeded params from ``gen`` (which lives on ``device``), zero
    moments."""
    params = model.init_params(gen, device)
    return TrainState(params=params, opt_state=opt.init(params, adamw),
                      step=torch.zeros((), dtype=torch.int32, device=device))


def abstract(model: Model,
             adamw: opt.AdamWConfig = opt.AdamWConfig()) -> TrainState:
    """The state as ``meta`` tensors: parameters, moments in
    ``adamw.moment_dtype`` and the int32 step (the dry run's input)."""
    params = model.abstract_params()
    return TrainState(params=params, opt_state=opt.init(params, adamw),
                      step=torch.zeros((), dtype=torch.int32, device="meta"))


def partition_specs(model: Model, mesh, rules: shd.Rules,
                    zero: bool = True) -> TrainState:
    """PartitionSpecs for TrainState: params by logical axes; moments with
    ZeRO sharding over ``data``."""
    axes = model.logical_axes()
    specs = model.param_specs()
    pspecs = shd.tree_partition_specs(axes, mesh, rules, specs)
    return TrainState(
        params=pspecs,
        opt_state=opt.state_partition_specs(pspecs, specs, mesh, zero=zero),
        step=shd.P(),
    )


def shardings(model: Model, mesh, rules: shd.Rules,
              zero: bool = True) -> TrainState:
    """:func:`partition_specs` as ``NamedSharding``\\ s on ``mesh``."""
    specs = partition_specs(model, mesh, rules, zero)
    is_p = dict(is_leaf=lambda x: isinstance(x, shd.PartitionSpec))

    def on(tree):
        return common.tree_map(lambda p: shd.NamedSharding(mesh, p), tree,
                               **is_p)

    o = specs.opt_state
    return TrainState(params=on(specs.params),
                      opt_state=opt.AdamWState(step=on(o.step), mu=on(o.mu),
                                               nu=on(o.nu)),
                      step=on(specs.step))
