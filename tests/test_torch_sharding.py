"""The port's logical-axis rules and spec trees against the JAX package's.

`repro_torch.parallel.sharding` keeps the JAX rules table and its
resolution (`spec_for`, `_prune_spec`, `ShardingConfig.resolved`); a
spec is a plain tuple, so it is compared with ``tuple(PartitionSpec)``.
The spec functions of every model module give each leaf's logical axes:
`lm.specs`, `lm.decode_state_specs` and `train.step.state_specs` must
equal JAX's for all ten configs at full size, leaf for leaf, once the
JAX tree is read in the port's layout (`repro_torch.convert`: layers
apart, so the stacked layout's leading "layers" axis, whose rule is
None, is dropped), and name exactly the leaves of the port's model.  No
spawn: `placements` is checked on a stand-in mesh of names and sizes.
"""
import dataclasses

import jax
import pytest
from jax.sharding import PartitionSpec as P

from repro import configs as jconfigs
from repro.models import lm as jlm
from repro.parallel import sharding as jshd
from repro.train import optimizer as jopt
from repro.train import step as jstep
from repro_torch import configs
from repro_torch.data import pipeline
from repro_torch.models import lm
from repro_torch.parallel import sharding as shd
from repro_torch.train import optimizer as opt
from repro_torch.train import step as step_mod

try:
    from hypothesis import given, settings, strategies as st
except ImportError:                                   # pragma: no cover
    from _minihyp import given, settings, strategies as st

NAMES = sorted(shd.DEFAULT_RULES) + ["unknown_axis"]
MESH_AXES = ("pod", "data", "model")


@pytest.fixture(autouse=True)
def _axes():
    """Both packages start from, and go back to, their default axes and
    no active rules (both keep them in module globals)."""
    for m in (shd, jshd):
        m.set_mesh_axes(MESH_AXES)
        m.set_active_rules(None)
    yield
    for m in (shd, jshd):
        m.set_mesh_axes(MESH_AXES)
        m.set_active_rules(None)


def _both(fn):
    return fn(shd), tuple(fn(jshd))


# -- the rules, on tests/test_substrate.py's cases ---------------------------

def test_rules_table_is_jax_s():
    assert shd.DEFAULT_RULES == jshd.DEFAULT_RULES


def test_spec_for_dedups_mesh_axes():
    got, want = _both(lambda m: m.spec_for(("batch", "seq", "embed"),
                                           rules={"embed": ("data",)}))
    assert got == want == (("pod", "data"), None, None)


def test_spec_for_drops_missing_mesh_axes():
    for m in (shd, jshd):
        m.set_mesh_axes(("data", "model"))
    got, want = _both(lambda m: m.spec_for(("batch", "seq")))
    assert got == want == ("data", None)


def test_prune_spec_divisibility():
    ms = {"data": 16, "model": 16}
    cases = [(("data", None, "model"), (8, 4096, 14336)),
             ((("data", "model"),), (32,)), ((("data", "model"),), (7,))]
    for spec, shape in cases:
        assert shd._prune_spec(spec, shape, ms) == \
            tuple(jshd._prune_spec(P(*spec), shape, ms))
    assert shd._prune_spec(*cases[0], ms) == (None, None, "model")
    assert shd._prune_spec(*cases[1], ms) == ("data",)
    assert shd._prune_spec(*cases[2], ms) == (None,)


@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("axes", [("data", "model"), MESH_AXES])
def test_sharding_config_resolved(fsdp, axes):
    for m in (shd, jshd):
        m.set_mesh_axes(axes)
    cfg, jcfg = (m.ShardingConfig(rules={"seq": ("model",)}, fsdp=fsdp)
                 for m in (shd, jshd))
    assert cfg.resolved() == jcfg.resolved()
    got, want = _both(lambda m: m.spec_for(
        ("embed", "mlp"), m.ShardingConfig(fsdp=fsdp).resolved()))
    assert got == want
    if fsdp and axes == ("data", "model"):
        assert got == ("data", "model")


# -- the rules, on drawn names, meshes and shapes ----------------------------

@settings(deadline=None, max_examples=150)
@given(st.lists(st.sampled_from(NAMES + [None]), min_size=0, max_size=5),
       st.lists(st.sampled_from(MESH_AXES), min_size=0, max_size=3,
                unique=True),
       st.booleans(),
       st.lists(st.tuples(st.sampled_from(NAMES),
                          st.lists(st.sampled_from(MESH_AXES), min_size=0,
                                   max_size=3, unique=True)),
                max_size=3))
def test_spec_for_equals_jax(logical, active, explicit, overrides):
    rules = {name: (tuple(axes) or None) for name, axes in overrides}
    for m in (shd, jshd):
        m.set_mesh_axes(active)
    kw = {"mesh_axes": active} if explicit else {}
    got, want = _both(lambda m: m.spec_for(logical, rules or None, **kw))
    assert got == want
    for m in (shd, jshd):
        m.set_active_rules(rules)
    got, want = _both(lambda m: m.spec_for(logical, **kw))
    assert got == want


@settings(deadline=None, max_examples=150)
@given(st.lists(st.tuples(st.sampled_from([None, "data", "model", "pod",
                                           ("data", "model"),
                                           ("pod", "data")]),
                          st.integers(1, 96)), min_size=1, max_size=4),
       st.integers(0, 2),
       st.tuples(st.sampled_from([1, 2, 3, 4, 16]),
                 st.sampled_from([1, 2, 4, 8, 16]),
                 st.sampled_from([1, 2, 3])))
def test_prune_spec_equals_jax(dims, short, sizes):
    spec = tuple(p for p, _ in dims)[:max(len(dims) - short, 0)]
    shape = tuple(n for _, n in dims)
    ms = dict(zip(("data", "model", "pod"), sizes))
    assert shd._prune_spec(spec, shape, ms) == \
        tuple(jshd._prune_spec(P(*spec), shape, ms))


# -- placements: a spec on a mesh, from names and sizes alone ----------------

@dataclasses.dataclass
class _Mesh:
    """What `placements` and `_prune_spec` read of a `DeviceMesh`."""
    mesh_dim_names: tuple
    shape: tuple

    @property
    def ndim(self):
        return len(self.shape)


def test_placements_shard_each_named_mesh_dim():
    from torch.distributed.tensor import Replicate, Shard
    mesh = _Mesh(("pod", "data", "model"), (2, 2, 2))
    assert shd.placements(mesh, (("pod", "data"), None, "model")) == \
        (Shard(0), Shard(0), Shard(2))
    assert shd.placements(mesh, (None, "data")) == \
        (Replicate(), Shard(1), Replicate())
    assert shd.placements(mesh, ()) == (Replicate(),) * 3
    pruned = shd.shardings_pruned(
        _Mesh(("data", "model"), (2, 4)), {"a": ("data", "model")},
        {"a": _Mesh((), (6, 6))})
    assert pruned == {"a": (Shard(0), Replicate())}


def test_constrain_leaves_a_plain_tensor_alone():
    import torch
    x = torch.ones(2, 3)
    assert shd.constrain(x, ("batch", "embed")) is x
    y = torch.zeros(2, 4, 3)
    shd.set_rows(y, torch.tensor([0, 1]), torch.tensor([2, 0]),
                 torch.tensor([[1., 2., 3.], [4., 5., 6.]]))
    assert y[0, 2].tolist() == [1., 2., 3.] and y[1, 0].tolist() == \
        [4., 5., 6.] and float(y.abs().sum()) == 21.0
    assert shd.like(x, y) is x


def test_input_sharding_places_the_batch_by_rule():
    from torch.distributed.tensor import Replicate, Shard
    shd.set_mesh_axes(("data", "model"))
    got = pipeline.input_sharding(_Mesh(("data", "model"), (2, 2)))
    assert got == {"tokens": (Shard(0), Replicate()),
                   "labels": (Shard(0), Replicate())}
    assert step_mod.batch_specs() == jstep.batch_specs()


# -- the spec trees of all ten configs ---------------------------------------

def _jax_flat(tree, cfg, stack_layers):
    """JAX spec tree -> {port name: axes}: each stack's layers read in
    the port's order (groups, then the remainder), the stacked layout's
    leading "layers" axis dropped."""
    out = {}
    paths, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, tuple) and all(
            a is None or isinstance(a, str) for a in x))
    for path, axes in paths:
        keys = [getattr(k, "key", getattr(k, "idx", None)) for k in path]
        if keys[0] in ("stack", "enc_stack") or (
                keys[0] == "opt" and keys[1] in ("stack", "enc_stack")):
            lead = keys[:keys.index("stack" if "stack" in keys
                                    else "enc_stack") + 1]
            rest = keys[len(lead):]
            pattern = cfg.pattern if lead[-1] == "stack" else \
                cfg.enc_pattern
            per = len(pattern)
            n_groups = stack_layers[lead[-1]] // per
            kind, rest = rest[0], rest[1:]
            if kind == "groups":
                i, rest = int(rest[0][1:]), rest[1:]
                assert axes[0] == "layers"
                for g in range(n_groups):
                    out[".".join(map(str, lead + [g * per + i] + rest))] = \
                        axes[1:]
                continue
            if kind == "group_list":
                j = rest[0] * per + int(rest[1][1:])
                rest = rest[2:]
            else:                                         # "rem"
                j = n_groups * per + rest[0]
                rest = rest[1:]
            out[".".join(map(str, lead + [j] + rest))] = axes
        else:
            out[".".join(map(str, keys))] = axes
    return out


def _layers(cfg):
    return {"stack": cfg.n_layers, "enc_stack": cfg.enc_layers}


@pytest.mark.parametrize("quant", [None, 8])
@pytest.mark.parametrize("name", configs.ARCHS)
def test_param_specs_equal_jax(name, quant):
    cfg, jcfg = configs.get(name, quant), jconfigs.get(name, quant)
    got = lm.specs(cfg)
    want = _jax_flat(jlm.specs(jcfg), jcfg, _layers(jcfg))
    assert got == want
    # the JAX tree's own leaves, per layer: decoder and encoder
    assert len(lm.stack_specs(cfg)) == cfg.n_layers
    assert lm._flat(lm.stack_specs(cfg), "stack") == {
        k: v for k, v in want.items() if k.startswith("stack.")}


@pytest.mark.parametrize("name", configs.ARCHS)
def test_decode_state_specs_equal_jax(name):
    cfg, jcfg = configs.get(name), jconfigs.get(name)
    got = lm._flat(lm.decode_state_specs(cfg), "stack")
    want = _jax_flat({"stack": jlm.decode_state_specs(jcfg)}, jcfg,
                     _layers(jcfg))
    assert got == want


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("name", configs.ARCHS)
def test_train_state_specs_equal_jax(name, int8):
    cfg, jcfg = configs.get(name), jconfigs.get(name)
    tcfg = step_mod.TrainConfig(adamw=opt.AdamWConfig(
        int8_second_moment=int8))
    jtcfg = jstep.TrainConfig(adamw=jopt.AdamWConfig(
        int8_second_moment=int8))
    got = step_mod.state_specs(cfg, tcfg)
    want = jstep.state_specs(jcfg, jtcfg)
    assert got["step"] == want["step"] == ()
    assert got["params"] == _jax_flat(want["params"], jcfg, _layers(jcfg))
    assert lm._flat(got["opt"], "opt") == _jax_flat(
        {"opt": want["opt"]}, jcfg, _layers(jcfg))
    moments = {"m", "v_q", "v_s"} if int8 else {"m", "v"}
    assert all(set(s) == moments for s in got["opt"].values())


@pytest.mark.parametrize("quant", [None, 8])
@pytest.mark.parametrize("name", configs.ARCHS)
def test_every_leaf_has_a_spec_of_its_rank(name, quant):
    """At full width, one pattern period deep (each layer kind once; the
    depth adds copies of the same leaves)."""
    import torch
    cfg = configs.get(name, quant)
    cfg = dataclasses.replace(cfg, n_layers=len(cfg.pattern),
                              enc_layers=min(cfg.enc_layers,
                                             len(cfg.enc_pattern)))
    meta = torch.device("meta")
    model = lm.LM(cfg, torch.Generator(), meta)
    sd = model.state_dict()
    specs = lm.specs(cfg)
    assert set(specs) == set(sd)
    assert all(len(specs[k]) == t.dim() for k, t in sd.items())
    if quant:
        packed = [k for k in sd if k.endswith(".packed")]
        assert len(packed) == lm.packed_projections(model) + \
            lm.packed_projections(model, encoder=True) > 0
    states = lm.decode_state_init(cfg, 1, 8, meta)
    sspecs = lm.decode_state_specs(cfg)
    assert len(states) == len(sspecs)
    for st_, sp in zip(states, sspecs):
        assert set(st_) == set(sp)
        assert all(len(sp[k]) == t.dim() for k, t in st_.items())
