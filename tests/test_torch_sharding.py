"""The port's sharding rules (``models/sharding.py``), the logical axes
and the ZeRO moment and train-state specs, held against the JAX package.

All of it is logic over shapes. The reference's own resolve cases
(``tests/test_sharding_and_opt.py``) run on the port; then, for every one
of the 13 configs at full width, the parameters', the AdamW moments' and
the decode cache's partition specs under ``RULES_TP`` and
``RULES_FSDP_TP``, on shape-only meshes of the production sizes (data 16
x model 16, and pod 2 x data 16 x model 16), equal the reference's as
tuples, leaf by canonical key. No device is involved on either side.
"""
import numpy as np
import pytest
from jax.sharding import PartitionSpec as JP

from repro.configs import SHAPES as J_SHAPES
from repro.configs import get_config as j_get_config
from repro.models import common as jcommon
from repro.models import sharding as jshd
from repro.models.common import canonical_flat as j_canonical_flat
from repro.models.registry import build_model as j_build_model
from repro.train import optimizer as jopt
from repro.train import train_state as jts
from repro_torch.configs import get_config, list_configs
from repro_torch.models import common
from repro_torch.models import sharding as shd
from repro_torch.models.registry import build_model
from repro_torch.train import optimizer as opt
from repro_torch.train import train_state as ts

P = shd.PartitionSpec


class _FakeMesh:
    """The reference tests' shape-only mesh, for the reference's side."""

    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(self.shape)


MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}
RULES = ("tp", "fsdp_tp")


# -------------------------------------------- the reference's resolve cases

@pytest.mark.parametrize("axes,shape,expect", [
    (("vocab", "embed"), (151_936, 2560), P("model", "data")),
    (("vocab", "embed"), (50_280, 2560), P(None, "data")),        # 50280 % 16
    (("embed", "heads", "head_dim"), (2560, 32, 128), P("data", "model")),
    (("embed", "heads", "head_dim"), (7168, 56, 128), P("data",)),  # 56 % 16
    (("experts", "embed", "expert_mlp"), (128, 7168, 4864),
     P("model", "data")),
    (("experts", "embed", "expert_mlp"), (40, 1536, 512), P(None, "data")),
])
def test_resolve_best_effort_divisibility(axes, shape, expect):
    mesh = shd.MeshShape({"data": 16, "model": 16})
    got = shd.resolve(axes, mesh, shd.RULES_FSDP_TP, shape=shape)
    assert got == expect and isinstance(got, tuple)


def test_resolve_cache_hd_fallback():
    mesh = shd.MeshShape({"data": 16, "model": 16})
    axes = ("layers", "cache_batch", "cache_seq", "kv_heads", "cache_hd")
    # kv divisible (gemma kv=16): kv takes model, head_dim unsharded
    got = shd.resolve(axes, mesh, shd.RULES_TP, shape=(46, 128, 32768, 16, 128))
    assert got == P(None, "data", None, "model")
    # kv NOT divisible (qwen3 kv=8): head_dim takes the model axis
    got = shd.resolve(axes, mesh, shd.RULES_TP, shape=(36, 128, 32768, 8, 128))
    assert got == P(None, "data", None, None, "model")
    # prefill OUTPUT layout: seq-sharded over model
    axes_out = ("layers", "cache_batch", "cache_seq_out", "kv_heads", None)
    got = shd.resolve(axes_out, mesh, shd.RULES_TP,
                      shape=(36, 32, 32768, 8, 128))
    assert got == P(None, "data", "model")


def test_resolve_never_reuses_mesh_axis():
    mesh = shd.MeshShape({"data": 16, "model": 16})
    got = shd.resolve(("vocab", "mlp"), mesh, shd.RULES_TP, shape=(160, 160))
    flat = [a for e in got for a in (e if isinstance(e, tuple) else (e,)) if a]
    assert len(flat) == len(set(flat))


@pytest.mark.parametrize("seed", range(4))
def test_resolve_divisibility_and_reference_agree_on_random_axes(seed):
    """The reference's divisibility property, on seeded random axes and
    dims under every named rule set and both meshes, and each spec equal
    to the reference's."""
    rng = np.random.default_rng(seed)
    names = ["embed", "vocab", "heads", "mlp", "kv_heads", "cache_batch",
             "cache_seq", "cache_hd", "batch", "experts", None]
    for _ in range(50):
        n = int(rng.integers(1, 5))
        axes = tuple(names[i] for i in rng.integers(0, len(names), n))
        shape = tuple(int(d) for d in rng.integers(1, 4097, n))
        for mesh_shape in MESHES.values():
            mesh = shd.MeshShape(mesh_shape)
            for rules in ("tp", "fsdp_tp", "fsdp_tp_sp", "long"):
                got = shd.resolve(axes, mesh, shd.named_rules(rules),
                                  shape=shape)
                want = jshd.resolve(axes, _FakeMesh(mesh_shape),
                                    jshd.named_rules(rules), shape=shape)
                assert tuple(got) == tuple(want), (axes, shape, rules)
                for i, entry in enumerate(got):
                    if entry is None:
                        continue
                    axes_t = entry if isinstance(entry, tuple) else (entry,)
                    total = int(np.prod([mesh.shape[a] for a in axes_t]))
                    assert shape[i] % total == 0


def test_rule_sets_equal_the_reference():
    for name in ("tp", "fsdp_tp", "fsdp_tp_sp", "long"):
        assert shd.named_rules(name) == jshd.named_rules(name)
    assert shd.FALLBACK_AXES == jshd.FALLBACK_AXES


# ------------------------------------------------- every config, full width

def _tuples(tree, spec_type):
    return {k: tuple(v) for k, v in j_canonical_flat(
        tree, is_leaf=lambda x: isinstance(x, spec_type)).items()}


def _port_tuples(tree):
    return {k: tuple(v) for k, v in common.canonical_flat(tree).items()}


@pytest.mark.parametrize("arch", list_configs())
def test_param_moment_and_cache_specs_equal_the_reference(arch):
    """Parameters (``train_state.partition_specs``), the ZeRO moments and
    the decode_32k cache (B=128, 32,768 slots) under both rule sets and on
    both production mesh shapes, leaf by canonical key."""
    jm, tm = j_build_model(j_get_config(arch)), build_model(get_config(arch))
    j_axes = j_canonical_flat(jm.logical_axes(),
                              is_leaf=lambda x: isinstance(x, tuple))
    assert common.canonical_flat(tm.logical_axes()) == j_axes
    shape = J_SHAPES["decode_32k"]
    jcache = jm.cache_specs(shape.global_batch, shape.seq_len)
    tcache = tm.cache_specs(shape.global_batch, shape.seq_len)
    # the reference's ssm caches carry ``pos`` as an int32 leaf (axes ());
    # the port's cache keeps it a host int beside the specs
    jcache = {k: v for k, v in jcache.items() if k != "pos"}
    assert common.canonical_flat(common.logical_axes(tcache)) == \
        j_canonical_flat(jcommon.logical_axes(jcache),
                         is_leaf=lambda x: isinstance(x, tuple))
    for mesh_name, mesh_shape in MESHES.items():
        jmesh, tmesh = _FakeMesh(mesh_shape), shd.MeshShape(mesh_shape)
        for rules in RULES:
            jr, tr = jshd.named_rules(rules), shd.named_rules(rules)
            jstate = jts.partition_specs(jm, jmesh, jr)
            tstate = ts.partition_specs(tm, tmesh, tr)
            what = f"{arch} {mesh_name} {rules}"
            assert _port_tuples(tstate.params) == \
                _tuples(jstate.params, JP), what
            for mom in ("mu", "nu"):
                assert _port_tuples(getattr(tstate.opt_state, mom)) == \
                    _tuples(getattr(jstate.opt_state, mom), JP), what
            assert tuple(tstate.step) == tuple(jstate.step) == ()
            assert tuple(tstate.opt_state.step) == ()
            jc = jshd.tree_partition_specs(jcommon.logical_axes(jcache),
                                           jmesh, jr,
                                           jcommon.abstract_params(jcache))
            tc = shd.tree_partition_specs(common.logical_axes(tcache), tmesh,
                                          tr, tcache)
            assert _port_tuples(tc) == _tuples(jc, JP), what


def test_zero_moment_spec_takes_the_first_divisible_free_dim():
    """The reference's rule on hand cases: ``data`` goes to the first
    unsharded dim it divides; a spec that already uses ``data``, or a
    mesh without it, is kept."""
    mesh = shd.MeshShape({"data": 16, "model": 16})
    assert opt.zero_moment_spec(P(None, "model"), (32, 896, 14), mesh) == \
        P("data", "model")
    assert opt.zero_moment_spec(P(None, "model"), (2, 896), mesh) == \
        P(None, "model")
    assert opt.zero_moment_spec(P("data"), (32, 16), mesh) == P("data")
    assert opt.zero_moment_spec(P(), (7, 32), mesh) == P(None, "data")
    no_data = shd.MeshShape({"model": 16})
    assert opt.zero_moment_spec(P(), (32,), no_data) == P()
    for ps, shape in ((P(None, "model"), (24, 896, 14)), (P(), (7, 32)),
                      (P("data"), (32, 16))):
        assert tuple(opt.zero_moment_spec(ps, shape, mesh)) == tuple(
            jopt.zero_moment_spec(JP(*ps), shape, _FakeMesh(mesh.shape)))
