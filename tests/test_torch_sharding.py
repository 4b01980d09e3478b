"""The port's sharding rules (``repro_torch.distributed.sharding``) and the
spec half of its train step against the reference's, entry for entry.

The reference's resolver runs on ``jax.sharding.AbstractMesh`` (jax 0.9 has
``AxisType``), the port's on its own ``AbstractMesh``: both compute on axis
names and sizes only.  The port's parameter tree has one dict a layer; each
of its block specs must be the reference's stacked spec with the leading
``"layer"`` entry dropped (that axis is never sharded), which
``convert.reference_layout`` checks by stacking them back.
"""
from __future__ import annotations

import jax
import pytest
from hypothesis import given, settings, strategies as st

from repro.configs import get_config as j_get_config
from repro.configs.base import RunConfig as JRun
from repro.distributed.sharding import (
    ShardingEnv as JEnv, activate as j_activate, axis_size as j_axis_size,
    fsdp_spec as j_fsdp, resolve_spec as j_resolve,
)
from repro.models.kvcache import build_cache as j_build_cache
from repro.training.train_step import (
    batch_pspecs as j_batch, opt_pspecs as j_opt, param_pspecs as j_param,
)
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.base import RunConfig
from repro_torch.convert import reference_layout
from repro_torch.distributed.sharding import (
    DEFAULT_RULES, AbstractMesh, P, ShardingEnv, activate, axis_size, fsdp_spec, placements,
    resolve_spec,
)
from repro_torch.launch.dryrun import _cache_pspecs
from repro_torch.training.train_step import (
    batch_pspecs, opt_pspecs, param_pspecs, state_pspecs, to_named,
)

MESHES = {
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
    "4x2": ((4, 2), ("data", "model")),
    "2x2": ((2, 2), ("data", "model")),
}


def _envs(mesh: str):
    shape, axes = MESHES[mesh]
    jm = jax.sharding.AbstractMesh(shape, axes,
                                   axis_types=(jax.sharding.AxisType.Auto,) * len(axes))
    return JEnv(jm), ShardingEnv(AbstractMesh(shape, axes))


def _t(spec) -> tuple:
    return tuple(spec)


class _Box:
    """A spec as a leaf of ``reference_layout`` (which walks into tuples)."""

    def __init__(self, spec):
        self.spec = spec


def _box(tree):
    if isinstance(tree, P):
        return _Box(tree)
    if isinstance(tree, dict):
        return {k: _box(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_box(v) for v in tree]
    return tree


def _stack(boxes):
    """The layers' specs of one stacked reference leaf: all equal, and the
    reference's spec is theirs behind an unsharded layer dim."""
    first = boxes[0].spec
    assert all(b.spec == first for b in boxes), [b.spec for b in boxes]
    entries = [None, *first]
    while entries and entries[-1] is None:
        entries.pop()
    return _Box(P(*entries))


def _as_reference(port_tree, cfg):
    """The port's per-layer spec tree in the reference's stacked layout, as
    nested dicts and lists of plain tuples."""
    def unbox(t):
        if isinstance(t, _Box):
            return _t(t.spec)
        if isinstance(t, dict):
            return {k: unbox(v) for k, v in t.items()}
        if isinstance(t, list):
            return [unbox(v) for v in t]
        return t
    return unbox(reference_layout(_box(port_tree), cfg, stack=_stack))


def _plain(jtree):
    """A reference spec tree as nested dicts and lists of plain tuples."""
    if isinstance(jtree, jax.sharding.PartitionSpec):
        return _t(jtree)
    if isinstance(jtree, dict):
        return {k: _plain(v) for k, v in jtree.items()}
    if isinstance(jtree, (list, tuple)):
        return [_plain(v) for v in jtree]
    return jtree


CELLS = [(a, m) for a in ARCH_IDS for m in MESHES]


@pytest.mark.parametrize("arch,mesh", CELLS, ids=[f"{a}-{m}" for a, m in CELLS])
def test_spec_trees_equal_the_references(arch, mesh):
    """param, opt (AdamW and Adafactor at ZeRO 0, 1, 3), batch (train,
    prefill, decode) and cache specs, every leaf, on one mesh."""
    je, te = _envs(mesh)
    cj, ct = j_get_config(arch), get_config(arch)
    for zs in (0, 1, 3):
        assert _as_reference(param_pspecs(ct, te, zs), ct) == _plain(j_param(cj, je, zs))
        for opt in ("adamw", "adafactor"):
            got = opt_pspecs(ct, te, RunConfig(model=ct, shape=None, optimizer=opt,
                                               zero_stage=zs))
            want = _plain(j_opt(cj, je, JRun(model=cj, shape=None, optimizer=opt,
                                             zero_stage=zs)))
            if opt == "adamw":
                got = {"m": _as_reference(got["m"], ct), "v": _as_reference(got["v"], ct),
                       "step": _t(got["step"])}
            else:
                got = {"f": [{k: _t(v) for k, v in f.items()} for f in got["f"]],
                       "step": _t(got["step"])}
            assert got == want, (opt, zs)
    for kind in ("train", "prefill", "decode"):
        for B in (1, 32, 256):
            got = {k: _t(v) for k, v in batch_pspecs(ct, te, B, kind=kind).items()}
            assert got == _plain(j_batch(cj, je, B, kind=kind)), (kind, B)
    for B, S in ((128, 32_768), (1, 524_288), (8, 2048)):
        with activate(te):
            got = _cache_pspecs(ct, te, B, S)
        with j_activate(je):
            want = j_build_cache(cj, lambda s, l, d: j_resolve(je, tuple(l), s), B, S)
        assert _as_reference(got, ct) == _plain(want), (B, S)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_axis_size_equals_the_references(mesh):
    je, te = _envs(mesh)
    for name in ("pod", "data", "model", "expert", "none"):
        assert axis_size(name, te) == j_axis_size(name, je)
    with activate(te), j_activate(je):
        assert axis_size("model") == j_axis_size("model")
    assert axis_size("model") == j_axis_size("model") == 1     # no env active


_LOGICAL = sorted(DEFAULT_RULES) + [None]


@settings(max_examples=300, deadline=None)
@given(mesh=st.sampled_from(list(MESHES)),
       dims=st.lists(st.tuples(st.sampled_from(_LOGICAL),
                               st.sampled_from([1, 2, 3, 4, 6, 7, 8, 16, 32, 40, 64, 96, 256])),
                     min_size=1, max_size=5),
       skip=st.integers(min_value=0, max_value=2))
def test_resolver_and_fsdp_match_the_reference_on_random_axes(mesh, dims, skip):
    je, te = _envs(mesh)
    axes = tuple(d[0] for d in dims)
    shape = tuple(d[1] for d in dims)
    assert _t(resolve_spec(te, axes, shape)) == _t(j_resolve(je, axes, shape))
    skip = min(skip, len(shape))
    assert _t(fsdp_spec(te, axes, shape, skip_leading=skip)) == \
        _t(j_fsdp(je, axes, shape, skip_leading=skip))


# twins of the reference's resolver tests (tests/test_training_infra.py)

def _env(shape=(4, 2), axes=("data", "model")):
    return ShardingEnv(AbstractMesh(shape, axes))


def test_resolver_divisibility_fallback():
    env = _env()
    # 6 heads on a 2-wide model axis: shardable; 7: dropped
    spec = resolve_spec(env, ("batch", "kv_heads"), (8, 6))
    assert spec == P("data", "model")
    spec2 = resolve_spec(env, ("batch", "kv_heads"), (8, 7))
    assert len(spec2) == 1  # model axis dropped


def test_resolver_no_axis_reuse():
    env = _env()
    spec = resolve_spec(env, ("heads", "ffn"), (4, 4))  # both want 'model'
    used = [s for s in spec if s is not None]
    assert used.count("model") <= 1


def test_fsdp_spec_adds_data_axis():
    env = _env()
    spec = fsdp_spec(env, ("layer", None, "ffn"), (3, 8, 4), skip_leading=1)
    # dim1 (=8) divisible by data(4): gets the fsdp axis
    assert spec[1] == "data"


def test_joint_entries_follow_mesh_order():
    """A joint entry lists its axes in mesh order (major to minor), the order
    DTensor shards over mesh dims; the resolver asserts it."""
    env = ShardingEnv(AbstractMesh((2, 16, 16), ("pod", "data", "model")))
    assert resolve_spec(env, ("batch",), (64,)) == P(("pod", "data"))
    bad = env.with_rules(batch=("data", "pod"))
    with pytest.raises(AssertionError):
        resolve_spec(bad, ("batch",), (64,))


def test_to_named_gives_dtensor_placements_on_a_fake_world():
    """to_named over a DeviceMesh of a fake world: Shard(i) where the axis
    sits in entry i, a joint entry as two Shard(0)s in mesh order, else
    Replicate."""
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.launch.mesh import fake_world, make_mesh
    cfg = get_config("gemma-7b")
    with fake_world(512):
        mesh = make_mesh((2, 16, 16), ("pod", "data", "model"))
        env = ShardingEnv(mesh)
        assert axis_size("model", env) == 16 and axis_size("pod", env) == 2
        b = to_named(env, batch_pspecs(cfg, env, 256, kind="train"))
        assert tuple(b["tokens"]) == (Shard(0), Shard(0), Replicate())
        run = RunConfig(model=cfg, shape=None, zero_stage=3)
        s = to_named(env, state_pspecs(cfg, env, run))
        # embed (V, D): vocab on model, D on data (FSDP)
        assert tuple(s["params"]["embed"]["w"]) == (Replicate(), Shard(1), Shard(0))
        # q (D, H, Dh): heads on model, D on data
        q = s["params"]["blocks"][0]["attn"]["q"]["w"]
        assert tuple(q) == (Replicate(), Shard(0), Shard(1))
        assert tuple(s["step"]) == (Replicate(),) * 3
        spec = param_pspecs(cfg, env, 3)["blocks"][0]["attn"]["q"]["w"]
        assert tuple(placements(mesh, spec)) == tuple(q)
    import torch.distributed as dist
    assert not dist.is_initialized()
