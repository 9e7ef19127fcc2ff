"""Unified model API: the :class:`Model` facade for the ``dense``, ``moe``,
``ssm`` (mamba2), ``hybrid`` (zamba2), ``audio`` (whisper) and ``vlm``
(llama-3.2-vision) families: every family of the JAX package.

    model.forward(params, batch, return_cache=False, ctx=None)
    model.decode_step(params, cache, batch, ctx=None)
    model.param_specs() / init_params(generator, device) / param_count()
    model.abstract_params() / active_param_count()
    model.cache_specs(batch, max_len) / abstract_cache / init_cache
    model.input_specs(shape, rl_train) / dummy_batch(generator, shape)

``batch`` is a dict with ``tokens``, ``frames`` for audio and ``vision``
for vlm, as in ``repro.models.registry``; an RLVR train batch also
carries ``behavior_logprobs``, ``advantages`` and ``loss_mask``. A cache is
its specs' tensors and ``pos``, a host int (the reference's int32 leaf).
``abstract_*`` give ``meta`` tensors: the dry run's inputs. ``ctx`` (a
slice of several devices, ``layers.Ctx``) runs every family over the
slice; audio's frames and vlm's patch embeddings go to every device of
it.
"""
from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Tuple

import torch

from repro_torch.configs import ModelConfig, ShapeSpec
from repro_torch.models import (common, hybrid, mamba2, transformer, vision,
                                whisper)

_FAMILY_MODULES = {"dense": transformer, "moe": transformer, "ssm": mamba2,
                   "hybrid": hybrid, "audio": whisper, "vlm": vision}


_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


class InputSpec(NamedTuple):
    """One model input of a cell: shape, dtype and logical axes."""
    shape: Tuple[int, ...]
    dtype: torch.dtype
    axes: tuple


class Model:
    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self.mod = _FAMILY_MODULES[cfg.family]

    # ------------------------------------------------------------- params
    def param_specs(self):
        return self.mod.param_specs(self.cfg)

    def init_params(self, gen: torch.Generator, device=None):
        return common.init_params(gen, self.param_specs(), device)

    def logical_axes(self):
        return common.logical_axes(self.param_specs())

    def abstract_params(self):
        return common.abstract_params(self.param_specs())

    def param_count(self) -> int:
        return common.param_count(self.param_specs())

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only top-k experts active)."""
        cfg = self.cfg
        total = self.param_count()
        if not cfg.num_experts:
            return total
        expert = sum(
            math.prod(s.shape) for key, s in
            common.canonical_flat(self.param_specs()).items()
            if "/moe/" in f"/{key}/" and any(
                w in key for w in ("wi_gate", "wi_up", "wo")))
        return total - expert + expert * cfg.experts_per_token \
            // cfg.num_experts

    # ------------------------------------------------------------ compute
    def _extras(self, batch: Dict[str, Any]):
        """The family's inputs beside the tokens: audio's frames, vlm's
        patch embeddings."""
        if self.cfg.family == "audio":
            return (batch["frames"],)
        if self.cfg.family == "vlm":
            return (batch["vision"],)
        return ()

    def forward(self, params, batch: Dict[str, Any],
                return_cache: bool = False, ctx=None):
        return self.mod.forward(params, self.cfg, batch["tokens"],
                                *self._extras(batch),
                                return_cache=return_cache, ctx=ctx)

    def decode_step(self, params, cache, batch: Dict[str, Any], ctx=None):
        return self.mod.decode_step(params, self.cfg, cache, batch["tokens"],
                                    ctx=ctx)

    def cache_specs(self, batch: int, max_len: int):
        return self.mod.cache_specs(self.cfg, batch, max_len)

    def abstract_cache(self, batch: int, max_len: int, pos: int = 0):
        """The decode cache as ``meta`` tensors, ``pos`` the next slot."""
        return dict(common.abstract_params(self.cache_specs(batch, max_len)),
                    pos=pos)

    def init_cache(self, gen: torch.Generator, batch: int, max_len: int,
                   device=None):
        """An empty decode cache (every spec is zeros) at ``pos`` 0."""
        return dict(common.init_params(gen, self.cache_specs(batch, max_len),
                                       device), pos=0)

    # ------------------------------------------------------------- inputs
    def input_specs(self, shape: ShapeSpec, rl_train: bool = True
                    ) -> Dict[str, InputSpec]:
        """Every model input of a cell (``repro/models/registry.py:
        118-145``): the tokens, audio's frames and vlm's patch embeddings
        outside a decode, and a train batch's RL fields."""
        cfg = self.cfg
        b, s = shape.global_batch, shape.seq_len
        dt = _DTYPES[cfg.dtype]
        out: Dict[str, InputSpec] = {}
        if shape.kind in ("train", "prefill"):
            out["tokens"] = InputSpec((b, s), torch.int32, ("batch", "seq"))
        else:  # decode: one new token against a cache of length seq_len
            out["tokens"] = InputSpec((b, 1), torch.int32,
                                      ("cache_batch", None))
        if cfg.family == "audio" and shape.kind != "decode":
            out["frames"] = InputSpec((b, cfg.encoder_seq, cfg.d_model), dt,
                                      ("batch", None, "embed"))
        if cfg.family == "vlm" and shape.kind != "decode":
            out["vision"] = InputSpec((b, cfg.vision_seq, cfg.d_model), dt,
                                      ("batch", None, "embed"))
        if shape.kind == "train" and rl_train:
            out["behavior_logprobs"] = InputSpec((b, s), torch.float32,
                                                 ("batch", "seq"))
            out["advantages"] = InputSpec((b,), torch.float32, ("batch",))
            out["loss_mask"] = InputSpec((b, s), torch.float32,
                                         ("batch", "seq"))
        return out

    def abstract_batch(self, shape: ShapeSpec, rl_train: bool = True):
        """:meth:`input_specs` as ``meta`` tensors."""
        return {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
                for k, v in self.input_specs(shape, rl_train).items()}

    def dummy_batch(self, gen: torch.Generator, shape: ShapeSpec,
                    rl_train: bool = True):
        """A random batch matching :meth:`input_specs`, drawn on ``gen``'s
        device in the order of the specs: token ids uniform in the
        vocabulary, floats N(0, 1) cast then scaled by 0.02,
        ``behavior_logprobs`` made negative, ``loss_mask`` ones. It matches
        the reference's in shapes, dtypes and ranges, not in values (the
        reference draws from jax's PRNG)."""
        dev = gen.device
        batch = {}
        for name, sp in self.input_specs(shape, rl_train).items():
            if not sp.dtype.is_floating_point:
                batch[name] = torch.randint(0, self.cfg.vocab_size, sp.shape,
                                            generator=gen, dtype=sp.dtype,
                                            device=dev)
            else:
                batch[name] = torch.randn(sp.shape, generator=gen,
                                          dtype=torch.float32, device=dev
                                          ).to(sp.dtype) * 0.02
        if "behavior_logprobs" in batch:
            batch["behavior_logprobs"] = -batch["behavior_logprobs"].abs()
        if "loss_mask" in batch:
            batch["loss_mask"] = torch.ones_like(batch["loss_mask"])
        return batch


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)
