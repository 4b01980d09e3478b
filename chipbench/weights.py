"""A configuration's weights, made on the device from ``--seed``.

The benchmark makes the weights and hands the same tensors to the port and to
the reference.  The layout is the one the port's ``Model`` takes, written out
by the configuration's family (``families/<family>.py``), not taken from the
port.

The leaves are laid end to end on one virtual stream of standard normal
draws, made in chunks of ``CHUNK`` by one generator call each, seeded from
(seed, chunk).  So a whole model takes a few large calls, and any leaf can be
made again alone (``initial_leaves``) without keeping a copy: the train cells
compare each parameter's change with its first value after the program has
overwritten it.  Matrices are N(0, 1/fan_in), norm scales 1 + N(0, 0.05^2),
biases N(0, 0.02^2), each rounded once to the served type.
"""
from __future__ import annotations

import math

import torch

from chipbench.harness import family

CHUNK = 1 << 28          # draws a generator call (1 GiB of float32)
NORM_STD = 0.05
BIAS_STD = 0.02
_MIX = 0x9E3779B97F4A7C15


def chunk_seed(seed: int, chunk: int) -> int:
    """A 63-bit generator seed for (seed, chunk); any whole ``seed``."""
    return (int(seed) * _MIX + chunk * 0xBF58476D1CE4E5B9 + 1) % (1 << 63)


def leaf_specs(cfg: dict) -> list[tuple[tuple, tuple, str, int]]:
    """(path, shape, kind, fan_in) of every leaf, in stream order: the
    configuration's family lays them out (``families/<family>.py``)."""
    return family(cfg).leaf_specs(cfg)


def path_name(path: tuple) -> str:
    return ".".join(str(p) for p in path)


def _scale(kind: str, fan_in: int, z: torch.Tensor) -> torch.Tensor:
    if kind == "matrix":
        return z * (1.0 / math.sqrt(fan_in))
    if kind == "norm":
        return 1.0 + NORM_STD * z
    return BIAS_STD * z


def initial_leaves(cfg: dict, seed: int, device, dtype=torch.bfloat16, chunk: int | None = None):
    """Yield (path, leaf) in stream order, each leaf made whole before it is
    yielded; one chunk of draws is held at a time."""
    device = torch.device(device)
    chunk = chunk or CHUNK
    cur, buf = -1, None
    off = 0
    for path, shape, kind, fan_in in leaf_specs(cfg):
        n = math.prod(shape)
        leaf = torch.empty(n, dtype=dtype, device=device)
        done = 0
        while done < n:
            c, at = divmod(off + done, chunk)
            if c != cur:
                buf = None
                gen = torch.Generator(device=device).manual_seed(chunk_seed(seed, c))
                buf = torch.randn(chunk, generator=gen, dtype=torch.float32, device=device)
                cur = c
            take = min(n - done, chunk - at)
            leaf[done:done + take].copy_(_scale(kind, fan_in, buf[at:at + take]))
            done += take
        off += n
        yield path, leaf.view(shape)
    del buf


def set_leaf(tree: dict, path: tuple, leaf) -> None:
    node = tree
    for key in path[:-1]:
        if isinstance(key, int):
            while len(node) <= key:
                node.append({})
            node = node[key]
        else:
            node = node.setdefault(key, [] if key == "blocks" else {})
    node[path[-1]] = leaf


def get_leaf(tree: dict, path: tuple):
    node = tree
    for key in path:
        node = node[key]
    return node


def make_params(cfg: dict, seed: int, device, dtype=torch.bfloat16,
                chunk: int | None = None) -> dict:
    """The whole tree, in the port's layout."""
    tree: dict = {}
    for path, leaf in initial_leaves(cfg, seed, device, dtype, chunk):
        set_leaf(tree, path, leaf)
    return tree


def count(cfg: dict) -> int:
    """Parameters of the configuration."""
    return sum(math.prod(shape) for _, shape, _, _ in leaf_specs(cfg))
