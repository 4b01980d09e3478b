"""Logical-axis sharding with divisibility-aware resolution (counterpart of
``repro/distributed/sharding.py``).

MaxText-style: model code annotates tensors with *logical* axis names; a rule
table maps logical names to mesh axes.  The resolver drops mesh axes that do
not divide the concrete dimension (e.g. qwen2.5's 40 heads on a 16-wide model
axis), which is what makes one model implementation trace correctly across
every (arch x shape x mesh) cell.

The resolver computes on names and sizes only, line for line as the
reference's.  Its mesh is anything with ``axis_names`` and a ``shape``
mapping: a ``torch.distributed.device_mesh.DeviceMesh`` (read through
:func:`mesh_axes`) or an :class:`AbstractMesh`, which needs no process group.
A spec ``P`` is a tuple with one entry a dim: ``None``, one mesh axis, or a
tuple of axes sharded jointly; trailing ``None``s are stripped.

:func:`logical_sharding` turns a spec into DTensor placements, one a mesh
dim: ``Shard(i)`` where the axis sits in entry ``i`` (and the dim has more
than one rank), else ``Replicate()``.
A joint entry such as ``("pod", "data")`` gives two ``Shard(0)``s; DTensor
shards left to right over mesh dims, which is the spec's major-to-minor order
only when the entry lists its axes in mesh order, so the resolver asserts it.

Usage:
    env = ShardingEnv(mesh)            # rules default to DEFAULT_RULES
    with activate(env):
        ...trace the step over DTensors...

Inside model code:
    x = logical_constraint(x, ("batch", "seq", "embed"))
is the identity unless an env is active and ``x`` is a DTensor, so the model
on one card (plain tensors) pays nothing for it.
"""
from __future__ import annotations

import contextlib
import math
import threading
from dataclasses import dataclass, field, replace
from typing import Any

import torch

# logical axis -> mesh axes, in order; multi-axis entries shard jointly.
DEFAULT_RULES: dict[str, tuple[str, ...]] = {
    "batch": ("pod", "data"),
    "seq": (),                 # unsharded by default
    "seq_sp": ("model",),      # Megatron-SP residual stream (norms, embeddings, logits)
    "seq_cp": ("model",),      # context-parallel attention (Ulysses-style)
    "kv_seq": ("model",),      # decode-time KV sequence sharding (flash-decode)
    "embed": (),
    "embed_tp": ("model",),    # row-parallel input dim
    "vocab": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "q_per_kv": (),
    "head_dim": (),
    "ffn": ("model",),
    "expert": ("model",),
    "expert_group": ("pod", "data"),   # MoE dispatch groups track the DP axes
    "expert_ffn": (),
    "lru_width": ("model",),
    "conv": (),
    "layer": (),               # scan-stacked leading dim: never sharded
    "fsdp": ("data",),         # ZeRO-3 parameter sharding axis
    "none": (),
}

class P(tuple):
    """A partition spec (``jax.sharding.PartitionSpec``): one entry a dim,
    each None, a mesh axis name, or a tuple of names sharded jointly."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


@dataclass(frozen=True)
class AbstractMesh:
    """A mesh of names and sizes with no devices (``jax.sharding.AbstractMesh``):
    ``shape`` maps each axis name to its size, in mesh order."""
    sizes: tuple[int, ...]
    axis_names: tuple[str, ...]

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))


def mesh_axes(mesh) -> tuple[tuple[str, ...], dict[str, int]]:
    """(axis names in mesh order, {name: size}) of an AbstractMesh or a
    DeviceMesh with ``mesh_dim_names``."""
    if isinstance(mesh, AbstractMesh):
        return mesh.axis_names, mesh.shape
    names = tuple(mesh.mesh_dim_names)
    return names, dict(zip(names, mesh.shape))


@dataclass(frozen=True)
class ShardingEnv:
    mesh: Any
    rules: dict[str, tuple[str, ...]] = field(default_factory=lambda: dict(DEFAULT_RULES))

    def with_rules(self, **overrides: tuple[str, ...]) -> "ShardingEnv":
        r = dict(self.rules)
        r.update(overrides)
        return replace(self, rules=r)

    @property
    def axis_names(self) -> tuple[str, ...]:
        return mesh_axes(self.mesh)[0]

    @property
    def shape(self) -> dict[str, int]:
        return mesh_axes(self.mesh)[1]


_tls = threading.local()


def active_env() -> ShardingEnv | None:
    return getattr(_tls, "env", None)


@contextlib.contextmanager
def activate(env: ShardingEnv):
    prev = active_env()
    _tls.env = env
    try:
        yield env
    finally:
        _tls.env = prev


def axis_size(name: str, env: ShardingEnv | None = None) -> int:
    """Size of a mesh axis (1 if absent / no env)."""
    env = env or active_env()
    if env is None or name not in env.axis_names:
        return 1
    return env.shape[name]


def _mesh_axis_prod(env: ShardingEnv, axes: tuple[str, ...]) -> int:
    return math.prod(env.shape[a] for a in axes) if axes else 1


def resolve_spec(env: ShardingEnv, logical_axes: tuple[str | None, ...],
                 shape: tuple[int, ...]) -> P:
    """Map logical axes -> spec, dropping non-dividing / reused axes.

    Multi-axis rules (e.g. batch -> (pod, data)) degrade gracefully: axes are
    dropped from the front until the product divides the dimension.
    """
    assert len(logical_axes) == len(shape), (logical_axes, shape)
    names = env.axis_names
    used: set[str] = set()
    entries = []
    for logical, dim in zip(logical_axes, shape):
        if logical is None:
            entries.append(None)
            continue
        cands = tuple(a for a in env.rules.get(logical, ())
                      if a in names and a not in used)
        while cands and dim % _mesh_axis_prod(env, cands) != 0:
            cands = cands[1:]
        if not cands:
            entries.append(None)
        else:
            # a joint entry shards major to minor; DTensor does so in mesh order
            assert list(cands) == sorted(cands, key=names.index), (logical, cands, names)
            used.update(cands)
            entries.append(cands if len(cands) > 1 else cands[0])
    while entries and entries[-1] is None:
        entries.pop()
    return P(*entries)


def spec_axes(entry) -> tuple[str, ...]:
    """The mesh axes of one spec entry."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def placements(mesh, spec: P) -> tuple:
    """DTensor placements of a spec over ``mesh``: one a mesh dim, ``Shard(i)``
    where that dim's axis sits in entry ``i``, else ``Replicate()``.  A mesh
    dim of size 1 is ``Replicate()`` whatever the spec (a shard over one rank
    is the whole dim, and DTensor's view rules would still treat it as
    split)."""
    from torch.distributed.tensor import Replicate, Shard
    names, sizes = mesh_axes(mesh)
    dim_of = {a: i for i, e in enumerate(spec) for a in spec_axes(e)}
    return tuple(Shard(dim_of[a]) if a in dim_of and sizes[a] > 1 else Replicate()
                 for a in names)


def logical_sharding(logical_axes: tuple[str | None, ...], shape: tuple[int, ...],
                     env: ShardingEnv | None = None):
    """``(mesh, placements)`` of the logical axes for ``shape``, or None
    without an env."""
    env = env or active_env()
    if env is None:
        return None
    return env.mesh, placements(env.mesh, resolve_spec(env, logical_axes, shape))


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def contiguous_stride(shape) -> tuple:
    """The row-major strides of ``shape`` (a ``DTensor.from_local``'s global
    stride)."""
    stride, acc = [], 1
    for d in reversed(tuple(shape)):
        stride.append(acc)
        acc *= d
    return tuple(reversed(stride))


class _Reduced(torch.autograd.Function):
    """``x.redistribute(mesh, pl)`` from partial sums, whose gradient goes
    back with the partial mesh dims replicated (the gradient of a sum is
    whole on every rank), as DTensor's own backward does for Partial ->
    Replicate: a reduce-scatter forward, an all-gather backward (Megatron
    SP's pair).  DTensor's backward for Partial -> Shard asks for Shard ->
    Partial, which some torch releases lack."""

    @staticmethod
    def forward(ctx, x, mesh, pl):
        from torch.distributed.tensor import Replicate
        ctx.mesh = mesh
        ctx.back = tuple(Replicate() if a.is_partial() else a for a in x.placements)
        return x.redistribute(mesh, pl)

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(ctx.mesh, ctx.back), None, None


def redistribute(x, mesh, pl):
    """``x.redistribute(mesh, pl)`` for a DTensor ``x``; from partial sums
    through :class:`_Reduced`."""
    pl = tuple(pl)
    if tuple(x.placements) == pl:
        return x
    if any(a.is_partial() for a in x.placements):
        return _Reduced.apply(x, mesh, pl)
    return x.redistribute(mesh, pl)


def logical_constraint(x: torch.Tensor, logical_axes: tuple[str | None, ...]) -> torch.Tensor:
    """``with_sharding_constraint`` by logical axes: the identity without an
    active env or for a plain tensor, else ``x`` redistributed to the
    placements the rules give."""
    env = active_env()
    if env is None or not is_dtensor(x):
        return x
    mesh, pl = logical_sharding(logical_axes, tuple(x.shape), env)
    return redistribute(x, mesh, pl)


def fsdp_spec(env: ShardingEnv, logical_axes: tuple[str | None, ...],
              shape: tuple[int, ...], *, skip_leading: int = 0) -> P:
    """Add the fsdp ('data') axis to the first eligible dim of a parameter
    spec (ZeRO-3 / FSDP parameter sharding).  ``skip_leading`` protects the
    scan-stacked layer dim."""
    base = resolve_spec(env, logical_axes, shape)
    entries = list(base) + [None] * (len(shape) - len(base))
    used = {a for e in entries if e is not None
            for a in (e if isinstance(e, tuple) else (e,))}
    fsdp_axes = tuple(a for a in env.rules.get("fsdp", ()) if a in env.axis_names)
    if not fsdp_axes or any(a in used for a in fsdp_axes):
        return base
    size = _mesh_axis_prod(env, fsdp_axes)
    for i in range(skip_leading, len(shape)):
        if entries[i] is None and shape[i] % size == 0:
            entries[i] = fsdp_axes if len(fsdp_axes) > 1 else fsdp_axes[0]
            break
    while entries and entries[-1] is None:
        entries.pop()
    return P(*entries)
